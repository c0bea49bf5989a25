#!/usr/bin/env bash
# The final check of a tree on the card, run from the root of the repo.
#
# Before it runs, unpack the tree to test into build/archive and, for the
# A/B of one phase, the commit it is compared with into build/parent:
#
#   git add -A && mkdir -p build/archive build/parent
#   git archive "$(git write-tree)" | tar -x -C build/archive
#   git archive PARENT_COMMIT | tar -x -C build/parent
#
# It runs chip_smoke.py from build/archive (the committed files alone;
# phases spec, qos, disagg, fleet, host_ps and ps_sparse among its
# phases), profiles the slices named by its second argument from there
# (default: the decode steps, the dense and paged serving engines' decode
# iterations and the speculative engine's rounds), runs the phases named
# by its first argument (default: host_ps,ps_sparse, the in-process host
# parameter server and its sharded, top-k and row-sparse commits; a
# comma-separated list runs each in turn, a side whose chip_smoke.py
# lacks a phase logs it as absent) in the order parent, change, change,
# parent when build/parent exists, and last runs the script chip_smoke.py
# alone in an empty directory, where it must fail.  The logs go to
# chiprun_out/.
#
#   bash tools/chip_final.sh [PHASES [SLICES]]
set -u
phase="${1:-host_ps,ps_sparse}"
slices="${2:-decode,serve,paged,spec}"
out="$(pwd)/chiprun_out"
mkdir -p "$out"
(cd build/archive && python3 chip_smoke.py > "$out/smoke_final.log" 2>&1)
echo "smoke_rc=$?"
(cd build/archive && python3 tools/profile_torch_slice.py --slices "$slices" \
    --out "$out/profile_final.json" > "$out/profile_final.log" 2>&1)
echo "prof_rc=$?"
if [ -d build/parent ]; then
  log="$out/${phase//,/_}_ab.log"
  : > "$log"
  for side in parent archive archive parent; do
    (cd "build/$side" && python3 -c "import sys; sys.path.insert(0, '.'); \
import chip_smoke as c
for p in '$phase'.split(','):
    run = getattr(c, 'phase_' + p, None)
    if run is None:
        print('{\"phase\": \"%s\", \"absent\": \"$side\"}' % p)
    else:
        run('$side')" >> "$log" 2>&1)
    echo "$side rc=$?"
  done
fi
rm -rf build/alone && mkdir -p build/alone
cp build/archive/chip_smoke.py build/alone/
(cd build/alone && python3 chip_smoke.py > "$out/alone_final.log" 2>&1)
echo "alone_rc=$?"
tail -3 "$out/smoke_final.log" | cut -c1-400
