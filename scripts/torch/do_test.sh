#!/bin/bash
# Eval entry of the PyTorch port (dldkd_tpu_torch): the same CLI contract
# as scripts/do_test.sh. <model_dir> holds the run's opt.json and ckpt/
# (model.ckpt, model_cfg.json). Runs on the CUDA card; append
# --torch_device cpu to run on the CPU.
# Usage: ./do_test.sh $collection $visual_feature $root_path $model_dir [flags...]
set -e

collection=$1
visual_feature=$2
root_path=$3
model_dir=$4

python -m dldkd_tpu_torch.infer --collection $collection --visual_feature $visual_feature \
    --root_path "$root_path" --dset_name $collection --model_dir "$model_dir" "${@:5}"
