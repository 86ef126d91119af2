#!/bin/bash
# Charades-STA training run on the PyTorch port (dldkd_tpu_torch): the same
# CLI contract, flags and hyperparameters as scripts/do_charades.sh. Runs
# on the CUDA card; append --torch_device cpu to run on the CPU.
# Usage: ./do_charades.sh $root_path [flags...]
set -e

root_path=$1

exp_id="charades_DLDKD++"
collection=charades
visual_feature=i3d_rgb_lgi
model_name=DLDKD
q_feat_size=1024
drop=0.15
input_drop=0.15
lr=0.00024
label_style=soft

python -m dldkd_tpu_torch.train --collection $collection --visual_feature $visual_feature \
    --root_path "$root_path" --dset_name $collection \
    --model_name $model_name --lr $lr \
    --distill_loss_decay exp --exp_id $exp_id \
    --double_branch --q_feat_size $q_feat_size \
    --drop $drop --input_drop $input_drop \
    --label_style $label_style "${@:2}"
