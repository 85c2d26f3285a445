"""Tuned thresholds shared across the pipeline.

Semantics follow the reference (sylph src/constants.rs:1-17); values are part
of the algorithm's published behavior, so they are kept identical.
"""

# Poisson CDF cutoff for the coverage-outlier cut (src/constants.rs:3).
CUTOFF_PVALUE = 0.9999999999

# Minimum number of nonzero coverage samples for lambda inference
# (src/constants.rs:4).
SAMPLE_SIZE_CUTOFF = 25

# Lambda correction only attempted when median coverage <= this
# (src/constants.rs:5).
MEDIAN_ANI_THRESHOLD = 2.0

# Sketch artifact suffixes (src/constants.rs:6-9). Legacy suffixes are still
# accepted on input.
QUERY_FILE_SUFFIX = ".syldb"
SAMPLE_FILE_SUFFIX = ".sylsp"
QUERY_FILE_SUFFIX_VALID = (QUERY_FILE_SUFFIX, ".sylqueries")
SAMPLE_FILE_SUFFIX_VALID = (SAMPLE_FILE_SUFFIX, ".sylsample")

# Read-dedup fingerprinting is only consulted while a k-mer's count is below
# this (single-end path; src/constants.rs:14).
MAX_DEDUP_COUNT = 4

# Default false-positive rate of the paired-end dedup filter
# (src/constants.rs:16); > 0 selects the native fold's bloom filter.
DEFAULT_FPR = 0.0001

# Default minimum adjusted ANI filters (src/constants.rs:10-11).
MIN_ANI_DEF = 0.9        # query
MIN_ANI_P_DEF = 0.95     # profile

# Median coverage below which the >=1 mean is the final coverage estimate
# (src/constants.rs:12).
MAX_MEDIAN_FOR_MEAN_FINAL_EST = 15.0

# Streaming-median threshold for the --estimate-unknown read-identity
# heuristic (src/constants.rs:17).
MED_KMER_FOR_ID_EST = 3.0

# Defaults mirrored from the CLI schema (src/cmdline.rs:57-62,75-76,94-138).
DEFAULT_K = 31
DEFAULT_C = 200
DEFAULT_MIN_SPACING = 30
DEFAULT_MIN_COUNT_CORRECT = 3.0
DEFAULT_MIN_NUMBER_KMERS = 50.0
DEFAULT_REDUNDANT_ANI = 99.0
