#!/bin/bash
# Build tools/tma_stream_bench.cu for sm_90a into build/ and run the cases
# PERF.md cites (MODE COLS KC NS; modes in the source's header).  A failed
# case of modes 6-10 (a wrong sum, a launch error) makes the exit code 1.  On the
# card, from the root of the checkout.
set -e
mkdir -p build
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"${CUDA_HOME:-/usr/local/cuda}/bin/nvcc" -gencode arch=compute_90a,code=sm_90a \
    -O3 -std=c++17 -Xptxas -v -o build/tma_stream_bench tools/tma_stream_bench.cu
for args in "3 128 64 5" "0 128 64 5" "0 128 64 3" "0 128 64 2" \
            "0 128 32 6" "0 256 32 5" "1 128 64 5" "2 128 64 5" \
            "4 128 64 5" "5 128 64 5"; do
  build/tma_stream_bench $args
done
# the matmul's stage work (modes 6-10), twice in turns: the yardstick,
# variant (i) (7, 8), (ii) (9, 10) and (iii) (9 at 64 KB stages), at
# 128-, 256- and 4096-column tiles
for round in 1 2; do
  for args in "6 128 64 5" "7 128 64 5" "8 128 64 5" "9 128 64 5" \
              "10 128 64 5" "9 128 128 3" "10 128 128 3" \
              "6 256 32 5" "7 256 32 5" "8 256 32 5" "9 256 32 5" \
              "10 256 32 5" "9 256 64 3" \
              "6 4096 2 5" "7 4096 2 5" "8 4096 2 5" "9 4096 2 5" \
              "10 4096 2 5" "9 4096 4 3"; do
    build/tma_stream_bench $args || fail=1
  done
done
# what a ring inside the megakernel may add to a stage's path (FLAGS bits,
# the source's header), on deepseek-7b's 128-column tiles: variants (i)
# and (ii), twice in turns
for round in 1 2; do
  for mode in 7 9; do
    for flags in 0 1 2 4 8 16 31; do
      build/tma_stream_bench $mode 128 64 5 $flags || fail=1
    done
  done
done
# one CTA's rate when fewer CTAs stream (a plan's busiest worker streams
# while others wait): the yardstick against (ii) at 8-64 KB stages and
# its waits (FLAGS 1, 32, 64), at 132, 96, 64, 32 and 16 CTAs, twice
for round in 1 2; do
  for ctas in 132 96 64 32 16; do
    for args in "6 128 64 4 0" "9 128 64 4 0" "9 128 64 4 1" \
                "9 128 64 4 32" "9 128 64 4 64" "9 128 16 8 32" \
                "9 128 32 8 0" "9 128 64 6 0" "9 128 128 3 0" \
                "6 256 32 4 0" "9 256 32 4 0" "6 4096 2 4 0" \
                "9 4096 2 4 0"; do
      build/tma_stream_bench $args $ctas || fail=1
    done
  done
done
exit ${fail:-0}
