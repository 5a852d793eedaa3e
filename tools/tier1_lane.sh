#!/bin/bash
# Time the tier-1 lane (ROADMAP.md "Tier-1 verify": six xdist workers,
# one file a worker, 1,470 s limit) on a checkout, to compare two trees on
# one machine:
#   tools/tier1_lane.sh <checkout> <out-prefix>
# writes <out-prefix>.log and <out-prefix>.xml (junit) and appends
# "rc=<exit code> wall=<seconds>" to the log.
set -u
cd "$1" || exit 2
start=$(date +%s.%N)
timeout -k 10 1470 env JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest tests/ -q -m 'not slow' \
    --continue-on-collection-errors -p no:cacheprovider -p xdist -n 6 --dist loadfile \
    --junitxml="$2.xml" -p no:randomly > "$2.log" 2>&1
rc=$?
end=$(date +%s.%N)
echo "rc=$rc wall=$(python3 -c "print(round($end - $start, 1))")" >> "$2.log"
