#!/usr/bin/env bash
# run_sift1b_orca_nprobe20
# The PyTorch / CUDA port's launcher: the flags of examples/run_sift1b_orca_nprobe20.sh,
# token for token, through ivfhnsw_tpu_torch.drivers.orca_debug.
# -device defaults to cuda (an error without a card); append
#   -device cpu
# to run on the CPU with the kernels' plain versions. data/ and models/
# follow the layout that examples/setup_env.sh builds for both packages.
# For a filesystem-free smoke run append:
#   -synthetic 0 -nb 200000 -nt 100000 -nq 1000 -nc 1024
set -eu
cd "$(dirname "$0")/.."

data="${PWD}/data/SIFT1B"
model="${PWD}/models/SIFT1B"
mkdir -p "$model"

python -m ivfhnsw_tpu_torch.drivers.orca_debug \
  -M 16 -efConstruction 500 \
  -nb 1000000000 -nt 10000000 -nsubt 65536 -nc 993127 -nq 10000 -ngt 1000 -d 128 \
  -code_size 16 -do_opq off \
  -k 1 -nprobe 20 -max_codes 30000 -efSearch 100 -do_pruning off \
  -path_base "$data/bigann_base.bvecs" -path_learn "$data/bigann_learn.bvecs" \
  -path_q "$data/bigann_query.bvecs" -path_gt "$data/gnd/idx_1000M.ivecs" \
  -path_centroids "$data/centroids_sift1b.fvecs" -path_precomputed_idxs "$data/precomputed_idxs_sift1b.ivecs" \
  -path_pq "$model/pq16.pq" -path_norm_pq "$model/norm_pq16.pq" \
  -path_opq_matrix "$model/opq16.opq" \
  -path_index "$model/ivfhnsw_PQ16.index" "$@"
