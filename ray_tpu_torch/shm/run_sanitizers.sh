#!/bin/bash
# Sanitizer pass over the shm store (reference practice: C++ components
# run under TSAN/ASAN/UBSAN in CI, SURVEY §5.2).  Builds the real store
# code single-TU with the multi-threaded stress harness and runs it
# under ThreadSanitizer, AddressSanitizer(+UBSan), and a standalone
# UndefinedBehaviorSanitizer pass — pure UBSAN instruments without
# ASAN's shadow-memory remapping, so it additionally runs the shm
# layout at production addresses and traps on ANY report
# (-fno-sanitize-recover) instead of printing and continuing.
set -euo pipefail
cd "$(dirname "$0")"
out="${TMPDIR:-/tmp}/rtts_sanitizers"
mkdir -p "$out"
echo "== TSAN =="
g++ -O1 -g -fsanitize=thread -pthread shmstore_stress.cc -o "$out/stress_tsan" -lrt
"$out/stress_tsan"
echo "== ASAN+UBSAN =="
g++ -O1 -g -fsanitize=address,undefined -pthread shmstore_stress.cc -o "$out/stress_asan" -lrt
"$out/stress_asan"
echo "== UBSAN =="
g++ -O1 -g -fsanitize=undefined -fno-sanitize-recover=all -pthread shmstore_stress.cc -o "$out/stress_ubsan" -lrt
"$out/stress_ubsan"
echo "sanitizers clean"
