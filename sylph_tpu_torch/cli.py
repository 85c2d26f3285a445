"""Command-line interface: ``python -m sylph_tpu_torch {sketch, profile,
query, inspect}``.

The flags are sylph_tpu's (sylph src/cmdline.rs), less ``--tpu``, plus
``--device {cuda,cpu,host}`` (default cuda: seeding and containment run on
every visible GPU, or the first ``SYLPH_TPU_DEVICES``, unless the CPU is
asked for; ``host`` is the JAX CLI without ``--tpu``, the host engine: the
native C seeder and numpy, no GPU and no kernel). ``profile``/``query``
with ``--coordinator HOST:PORT --num-processes N --process-id i`` run as
process i of N (a gloo group, utils/distributed.py):
every process runs the same command, the grange engine splits the chunks
between them and merges the histograms, and process 0 writes the TSV; with
``--device cpu`` every process runs the plain kernels. ``sketch`` takes
genomes (``-g``,
fasta files, ``--gl``) into one ``.syldb`` and reads (``-r``, ``--rl``,
``-1/-2``, ``--l1/--l2``, fastq files) into ``.sylsp`` samples;
``profile``/``query`` take ``.syldb`` databases or genome fasta files, and
``.sylsp`` samples or raw reads, and with ``--serve`` keep the database
resident and answer sample paths read from stdin; ``--profile-trace DIR``
writes a torch.profiler trace; ``inspect`` prints sketch metadata as YAML
(host only).
"""

import argparse
import logging
import os
import sys

from .engine.inspect_cmd import InspectOptions, inspect
from .engine.runner import ContainOptions, contain, serve
from .engine.sketch_cmd import SketchOptions, sketch
from .utils.distributed import init_from_flags, shutdown


def _setup_logging(trace: bool = False, debug: bool = False):
    level = (logging.DEBUG - 5 if trace
             else logging.DEBUG if debug else logging.INFO)
    logging.basicConfig(
        stream=sys.stderr, level=level,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%SZ", force=True)


def _device_flag(p, what: str):
    p.add_argument("--device", choices=("cuda", "cpu", "host"),
                   default="cuda",
                   help=f"where {what} runs (default: the GPU; there is no "
                   "fallback to the CPU unless it is asked for). 'host' "
                   "runs the host engine: the native C seeder and numpy "
                   "probes, no GPU and no kernel")


def _add_sketch(sub):
    p = sub.add_parser(
        "sketch", help="Sketch genomes into a database (*.syldb) and reads "
        "into samples: each sample.fq -> sample.fq.sylsp.")
    p.add_argument("files", nargs="*", help="fasta/fastq files; gzip "
                   "optional. fasta = genomes, fastq = reads")
    p.add_argument("-o", "--out-name-db", dest="db_out_name",
                   default="database")
    p.add_argument("-d", "--sample-output-directory",
                   dest="sample_output_dir", default="./")
    p.add_argument("-i", "--individual-records", dest="individual",
                   action="store_true")
    p.add_argument("-r", "--reads", nargs="+", default=[])
    p.add_argument("-g", "--genomes", nargs="+", default=[])
    p.add_argument("-l", "--list", dest="list_sequence", default=None)
    p.add_argument("--rl", dest="list_reads", default=None)
    p.add_argument("--gl", dest="list_genomes", default=None)
    p.add_argument("--l1", dest="list_first_pair", default=None)
    p.add_argument("--l2", dest="list_second_pair", default=None)
    p.add_argument("-1", "--first-pairs", dest="first_pair", nargs="+",
                   default=[])
    p.add_argument("-2", "--second-pairs", dest="second_pair", nargs="+",
                   default=[])
    p.add_argument("-S", "--sample-names", dest="sample_names", nargs="+",
                   default=None)
    p.add_argument("--lS", dest="list_sample_names", default=None)
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-c", type=int, default=200)
    p.add_argument("-t", dest="threads", type=int, default=3)
    p.add_argument("--ram-barrier", dest="max_ram", type=int, default=None)
    p.add_argument("--no-dedup", dest="no_dedup", action="store_true")
    p.add_argument("--disable-profiling", dest="no_pseudotax",
                   action="store_true")
    p.add_argument("--min-spacing", dest="min_spacing_kmer", type=int,
                   default=30)
    p.add_argument("--fpr", type=float, default=0.0001)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--debug", action="store_true")
    _device_flag(p, "seeding")
    return p


def _add_contain(sub, name, helptext):
    p = sub.add_parser(name, help=helptext)
    p.add_argument("files", nargs="*")
    p.add_argument("-l", "--list", dest="file_list", default=None)
    p.add_argument("--min-count-correct", type=float, default=3.0,
                   dest="min_count_correct")
    p.add_argument("-M", "--min-number-kmers", type=float, default=50.0,
                   dest="min_number_kmers")
    p.add_argument("-m", "--minimum-ani", type=float, default=None,
                   dest="minimum_ani")
    p.add_argument("-t", dest="threads", type=int, default=3)
    p.add_argument("-s", "--sample-threads", dest="sample_threads", type=int,
                   default=None)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("-u", "--estimate-unknown", dest="estimate_unknown",
                   action="store_true")
    p.add_argument("-I", "--read-seq-id", dest="seq_id", type=float,
                   default=None)
    p.add_argument("-R", "--redundancy-threshold", dest="redundant_ani",
                   type=float, default=99.0)
    p.add_argument("-r", "--reads", nargs="+", default=[])
    p.add_argument("-1", "--first-pairs", dest="first_pair", nargs="+",
                   default=[])
    p.add_argument("-2", "--second-pairs", dest="second_pair", nargs="+",
                   default=[])
    p.add_argument("-c", type=int, default=200)
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-i", "--individual-records", dest="individual",
                   action="store_true")
    p.add_argument("--min-spacing", dest="min_spacing_kmer", type=int,
                   default=30)
    p.add_argument("-o", "--output-file", dest="out_file_name", default=None)
    p.add_argument("--log-reassignments", dest="log_reassignments",
                   action="store_true")
    p.add_argument("-p", "--pseudotax", dest="pseudotax",
                   action="store_true")
    p.add_argument("--ratio", action="store_true")
    p.add_argument("--mme", action="store_true")
    p.add_argument("--mle", action="store_true")
    p.add_argument("--nb", action="store_true")
    p.add_argument("--no-ci", dest="no_ci", action="store_true")
    p.add_argument("--no-adjust", dest="no_adj", action="store_true")
    p.add_argument("--mean-coverage", dest="mean_coverage",
                   action="store_true")
    p.add_argument("--profile-trace", dest="profile_trace", default=None,
                   metavar="DIR",
                   help="write a torch.profiler trace of the samples' "
                   "processing to DIR (a Chrome trace file); a trace that "
                   "cannot be written fails the run")
    p.add_argument("--serve", action="store_true",
                   help="serving mode: load the database and build the "
                   "device index once, then read sample paths from stdin "
                   "(one per line, two whitespace-separated paths for a "
                   "read pair), writing each sample's TSV rows at once; "
                   "EOF ends the loop")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="several processes: the address process 0 listens "
                   "on. Run the SAME command in every process with "
                   "--num-processes/--process-id; the database-scale "
                   "device index shares its chunks between the processes "
                   "and process 0 writes the TSV")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", dest="process_id", type=int,
                   default=None, help=argparse.SUPPRESS)
    _device_flag(p, "seeding and containment")
    return p


def _add_inspect(sub):
    p = sub.add_parser("inspect",
                       help="Inspect sketched .syldb and .sylsp files.")
    p.add_argument("files", nargs="*")
    p.add_argument("-o", "--output-file", dest="out_file_name", default=None)
    return p


def build_parser():
    ap = argparse.ArgumentParser(
        prog="sylph-torch",
        description="GPU (PyTorch/CUDA) read sketching, genome ANI "
        "queries and taxonomic profiling of metagenomic samples.")
    sub = ap.add_subparsers(dest="mode")
    _add_sketch(sub)
    _add_contain(sub, "profile", "Species-level taxonomic profiling with "
                 "abundances and ANIs.")
    _add_contain(sub, "query", "Coverage-adjusted ANI querying between "
                 "databases and samples.")
    ap._sub_map = dict(sub.choices)       # for intermixed parsing in main()
    ap._inspect = _add_inspect(sub)
    return ap


def _contain_options(a) -> ContainOptions:
    estimator = "ratio"
    if a.ratio:
        estimator = "ratio"
    elif a.mme:
        estimator = "mme"
    elif a.nb:
        estimator = "nb"
    elif a.mle:
        estimator = "mle"
    return ContainOptions(
        files=a.files, file_list=a.file_list,
        min_count_correct=a.min_count_correct,
        min_number_kmers=a.min_number_kmers, minimum_ani=a.minimum_ani,
        threads=a.threads, sample_threads=a.sample_threads,
        estimate_unknown=a.estimate_unknown, seq_id=a.seq_id,
        redundant_ani=a.redundant_ani, reads=a.reads,
        first_pair=a.first_pair, second_pair=a.second_pair, c=a.c, k=a.k,
        individual=a.individual, min_spacing_kmer=a.min_spacing_kmer,
        out_file_name=a.out_file_name,
        log_reassignments=a.log_reassignments, pseudotax=a.pseudotax,
        estimator=estimator, no_ci=a.no_ci, no_adj=a.no_adj,
        mean_coverage=a.mean_coverage, device=a.device,
        profile_trace=a.profile_trace)


def _sketch_options(a) -> SketchOptions:
    return SketchOptions(
        files=a.files, db_out_name=a.db_out_name,
        sample_output_dir=a.sample_output_dir, individual=a.individual,
        reads=a.reads, genomes=a.genomes, list_sequence=a.list_sequence,
        list_reads=a.list_reads, list_genomes=a.list_genomes,
        list_first_pair=a.list_first_pair,
        list_second_pair=a.list_second_pair, first_pair=a.first_pair,
        second_pair=a.second_pair, sample_names=a.sample_names,
        list_sample_names=a.list_sample_names, k=a.k, c=a.c,
        threads=a.threads, max_ram=a.max_ram, no_dedup=a.no_dedup,
        no_pseudotax=a.no_pseudotax, min_spacing_kmer=a.min_spacing_kmer,
        fpr=a.fpr, device=a.device)


def _tune_allocator(module: str = "sylph_tpu_torch") -> None:
    """Re-exec ``python -m module`` once with glibc malloc tuned for
    streaming ingest (sylph_tpu/cli.py::_tune_allocator; the bench and the
    fixture generators re-exec the same way).

    The ingest cycles multi-MB buffers (decode blocks, code arrays) across
    threads; stock glibc gives each thread its own arena and mmaps and
    unmaps large blocks, so every block is first-touch-faulted again. One
    shared arena with no trim keeps the pages hot. glibc reads these only
    at process start, hence the exec. Opt out with SYLPH_NO_MALLOC_TUNE=1.
    """
    if os.environ.get("SYLPH_NO_MALLOC_TUNE") or \
            os.environ.get("MALLOC_MMAP_THRESHOLD_") is not None or \
            not sys.platform.startswith("linux"):
        return
    env = dict(os.environ,
               MALLOC_MMAP_THRESHOLD_="17179869184",
               MALLOC_TRIM_THRESHOLD_="-1",
               MALLOC_ARENA_MAX="1")
    try:
        os.execve(sys.executable, [sys.executable, "-m", module]
                  + list(sys.argv[1:]), env)
    except OSError:                      # exec denied: run untuned
        os.environ["SYLPH_NO_MALLOC_TUNE"] = "1"


def main(argv=None) -> int:
    if argv is None:
        _tune_allocator()
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    if not argv:
        ap.print_help(sys.stderr)
        return 2
    if argv[0] in ap._sub_map:
        # clap (the reference CLI) accepts flags interleaved between
        # positionals (`profile db.syldb -u sample.sylsp`)
        args = ap._sub_map[argv[0]].parse_intermixed_args(argv[1:])
        args.mode = argv[0]
    else:
        args = ap.parse_args(argv)
    if args.mode is None:
        ap.print_help(sys.stderr)
        return 2
    if args.mode == "inspect":
        _setup_logging()
        if not args.files:
            # the JAX CLI means to exit 2 here and exits 0: its help's
            # SystemExit(0) is caught (ROADMAP C)
            ap._inspect.print_help(sys.stderr)
            return 2
    else:
        _setup_logging(args.trace, args.debug)
    try:
        if args.mode == "sketch":
            sketch(_sketch_options(args))
        elif args.mode == "inspect":
            inspect(InspectOptions(files=args.files,
                                   out_file_name=args.out_file_name))
        else:
            grouped = init_from_flags(args.coordinator, args.num_processes,
                                      args.process_id)
            try:
                run = serve if args.serve else contain
                run(_contain_options(args),
                    pseudotax=(args.mode == "profile"))
            finally:
                if grouped:
                    shutdown()
    except SystemExit as e:
        return int(e.code or 0)
    except BrokenPipeError:
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
