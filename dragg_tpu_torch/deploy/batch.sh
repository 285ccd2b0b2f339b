#!/bin/bash
# SLURM batch script for the PyTorch port: one task a card, every task one
# rank of one run.  Submit from the repo root, with the run's arguments:
#
#   sbatch dragg_tpu_torch/deploy/batch.sh --config config.toml --outputs-dir outputs
#   sbatch --nodes=4 dragg_tpu_torch/deploy/batch.sh ...    # K nodes: the same script
#
# Each task finds its rank as jax.distributed.initialize() would: from
# SLURM_JOB_ID, SLURM_STEP_NODELIST, SLURM_NTASKS, SLURM_PROCID and
# SLURM_LOCALID (dragg_tpu_torch/parallel/world.py).  The coordinator is
# the step's first node, on port SLURM_JOB_ID % 4096 + 61440 unless
# JAX_COORDINATOR_PORT says otherwise.  No GPU is bound per task: every
# task sees its node's cards and drives the one of its local id.

#SBATCH --job-name=dragg-tpu-torch
#SBATCH --time=04:00:00
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=8
#SBATCH --gpus-per-node=8

set -euo pipefail
cd "${SLURM_SUBMIT_DIR:-$(dirname "$0")/../..}"
export DRAGG_DISTRIBUTED=1
# A kernel library built once on shared storage serves every rank:
#   export DRAGG_COMPILE_CACHE_DIR=/shared/dragg/kernels
srun python -u -m dragg_tpu_torch run "$@"
