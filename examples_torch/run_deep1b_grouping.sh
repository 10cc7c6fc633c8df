#!/usr/bin/env bash
# run_deep1b_grouping
# The PyTorch / CUDA port's launcher: the flags of examples/run_deep1b_grouping.sh,
# token for token, through ivfhnsw_tpu_torch.drivers.grouping_eval.
# -device defaults to cuda (an error without a card); append
#   -device cpu
# to run on the CPU with the kernels' plain versions. data/ and models/
# follow the layout that examples/setup_env.sh builds for both packages.
# For a filesystem-free smoke run append:
#   -synthetic 0 -nb 200000 -nt 100000 -nq 1000 -nc 1024
set -eu
cd "$(dirname "$0")/.."

data="${PWD}/data/DEEP1B"
model="${PWD}/models/DEEP1B"
mkdir -p "$model"

python -m ivfhnsw_tpu_torch.drivers.grouping_eval \
  -M 16 -efConstruction 500 \
  -nb 1000000000 -nt 10000000 -nsubt 262144 -nc 999973 -nq 10000 -ngt 1000 -d 96 \
  -code_size 16 -do_opq off -nsubc 64 \
  -k 1 -nprobe 210 -max_codes 100000 -efSearch 210 -do_pruning on \
  -path_base "$data/deep1B_base.fvecs" -path_learn "$data/deep1B_learn.fvecs" \
  -path_q "$data/deep1B_queries.fvecs" -path_gt "$data/deep1B_groundtruth.ivecs" \
  -path_centroids "$data/centroids_deep1b.fvecs" -path_precomputed_idxs "$data/precomputed_idxs_deep1b.ivecs" \
  -path_pq "$model/pq16_g64.pq" -path_norm_pq "$model/norm_pq16_g64.pq" \
  -path_opq_matrix "$model/opq16.opq" \
  -path_index "$model/ivfhnsw_PQ16_g64.index" "$@"
