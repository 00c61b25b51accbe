#!/bin/bash
# Build tools/tma_stream_bench.cu for sm_90a into build/ and run the cases
# PERF.md cites (MODE COLS KC NS; modes in the source's header).  On the
# card, from the root of the checkout.
set -e
mkdir -p build
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"${CUDA_HOME:-/usr/local/cuda}/bin/nvcc" -gencode arch=compute_90a,code=sm_90a \
    -O3 -std=c++17 -o build/tma_stream_bench tools/tma_stream_bench.cu
for args in "3 128 64 5" "0 128 64 5" "0 128 64 3" "0 128 64 2" \
            "0 128 32 6" "0 256 32 5" "1 128 64 5" "2 128 64 5" \
            "4 128 64 5" "5 128 64 5"; do
  build/tma_stream_bench $args
done
