"""The port's native FASTX parser (sylph_tpu_torch/native/fastxio.c) called
from many threads at once at its first use in a process.

The streaming ingest parses blocks on a pool of threads from its first
block on. A base-code table filled at first use (as the JAX package's
native/fastxio.c fills it: gcc stores its done flag before the table) lets
one thread parse while another is still filling the table, so bases decode
as A and a sketch loses k-mers. Each run of the harness below is a fresh
process whose threads make their first parse together, started ``gap`` ns
apart; every base of every thread's block must decode exactly. How often a
run catches a table filled at first use depends on the host: 1 run in 400
on an H100 machine's host (gcc 13.3). ``python
tests/test_torch_native_threads.py LIB [RUNS]`` counts the runs that go
wrong with a built parser library.
"""

import os
import shutil
import subprocess

import pytest

HARNESS = r"""
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef struct {            /* the head of fastxio.c's FxResult */
    uint8_t *codes;
    int64_t n_codes;
    int64_t *starts, *ends;
    int64_t n_records;
    char *names;
    int64_t names_len;
    char *error;
} FxResult;

static FxResult *(*parse)(const uint8_t *, int64_t, int);
static void (*fx_free)(FxResult *);
static pthread_barrier_t bar;
static uint8_t *block;
static int64_t block_len, n_bases, t0, gap;
static int bad;

static int64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

/* thread t makes its first parse gap * t ns after the others left the
 * barrier, then checks every base: record bases repeat C G T A */
static void *run(void *arg) {
    const int64_t t = (int64_t)(intptr_t)arg;
    if (pthread_barrier_wait(&bar) == PTHREAD_BARRIER_SERIAL_THREAD)
        __atomic_store_n(&t0, now_ns(), __ATOMIC_RELEASE);
    while (!__atomic_load_n(&t0, __ATOMIC_ACQUIRE)) {}
    while (now_ns() < t0 + 1000 + t * gap) {}
    FxResult *r = parse(block, block_len, 1);
    int ok = r && !r->error && r->n_codes == n_bases;
    for (int64_t i = 0; ok && i < n_bases; i++)
        ok = r->codes[i] == (uint8_t)((i + 1) % 4);
    if (!ok) __atomic_add_fetch(&bad, 1, __ATOMIC_RELAXED);
    fx_free(r);
    return NULL;
}

/* harness LIB THREADS GAP_NS: prints the threads that decoded a base
 * wrong, exits 1 if any did */
int main(int argc, char **argv) {
    if (argc != 4) return 2;
    void *lib = dlopen(argv[1], RTLD_NOW);
    if (!lib) return 2;
    parse = (FxResult *(*)(const uint8_t *, int64_t, int))dlsym(
        lib, "fx_parse_buffer");
    fx_free = (void (*)(FxResult *))dlsym(lib, "fx_free");
    const int nt = atoi(argv[2]), n_rec = 64, len = 160;
    gap = atoll(argv[3]);
    if (!parse || !fx_free || nt < 1 || nt > 64) return 2;
    block_len = (int64_t)n_rec * (2 * len + 7);
    block = (uint8_t *)malloc((size_t)block_len);
    uint8_t *p = block;
    for (int r = 0; r < n_rec; r++) {
        memcpy(p, "@r\n", 3);
        p += 3;
        for (int i = 0; i < len; i++) *p++ = "CGTA"[i % 4];
        memcpy(p, "\n+\n", 3);
        p += 3;
        memset(p, 'I', (size_t)len);
        p += len;
        *p++ = '\n';
    }
    n_bases = (int64_t)n_rec * len;
    pthread_t th[64];
    pthread_barrier_init(&bar, NULL, (unsigned)nt);
    for (int t = 0; t < nt; t++)
        pthread_create(&th[t], NULL, run, (void *)(intptr_t)t);
    for (int t = 0; t < nt; t++) pthread_join(th[t], NULL);
    printf("%d\n", bad);
    return bad != 0;
}
"""


def build_harness(d) -> str:
    """The harness binary in directory ``d``, built with the C compiler
    that builds the port's native libraries."""
    src, exe = os.path.join(d, "harness.c"), os.path.join(d, "harness")
    with open(src, "w") as f:
        f.write(HARNESS)
    r = subprocess.run([shutil.which("cc") or "cc", "-O2", "-pthread",
                        "-o", exe, src, "-ldl"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return exe


def failing_runs(harness: str, lib: str, gap_ns: int, runs: int) -> list:
    """The harness's output of each of ``runs`` fresh processes against
    the parser library ``lib`` that decoded a base wrong."""
    out = []
    for _ in range(runs):
        r = subprocess.run([harness, lib, "8", str(gap_ns)],
                           capture_output=True, text=True, timeout=60)
        if r.returncode != 0:
            out.append(f"{r.stdout.strip()} of 8 threads (rc "
                       f"{r.returncode}) {r.stderr}")
    return out


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(str(tmp_path_factory.mktemp("fastx_threads")))


@pytest.mark.parametrize("gap_ns", [0, 300, 1000, 3000])
def test_first_parses_from_many_threads_decode_every_base(harness, gap_ns):
    from sylph_tpu_torch.io import native
    lib = native.get_lib()._name      # built on first use, not yet parsed
    assert failing_runs(harness, lib, gap_ns, 150) == []


if __name__ == "__main__":
    # python tests/test_torch_native_threads.py LIB [RUNS]: how many of
    # RUNS fresh processes (default 100) decoded a base wrong with the
    # parser library LIB (a built native/fastxio.c), at each start gap
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        exe = build_harness(d)
        runs = int(sys.argv[2]) if len(sys.argv) > 2 else 100
        for gap in (0, 300, 1000, 3000):
            bad = failing_runs(exe, os.path.abspath(sys.argv[1]), gap, runs)
            print(f"gap {gap} ns: {len(bad)} of {runs} runs decoded a base "
                  f"wrong {bad[:3]}")
