#!/bin/bash
# ActivityNet-Captions training run on the PyTorch port (dldkd_tpu_torch):
# the same CLI contract, flags and hyperparameters as
# scripts/do_activitynet.sh. Runs on the CUDA card; append
# --torch_device cpu to run on the CPU.
# Usage: ./do_activitynet.sh $root_path [flags...]
set -e

root_path=$1

exp_id="ac_DLDKD++"
collection=activitynet
visual_feature=i3d
model_name=DLDKD
q_feat_size=1024
drop=0.25
input_drop=0.25
label_style=soft

python -m dldkd_tpu_torch.train --collection $collection --visual_feature $visual_feature \
    --root_path "$root_path" --dset_name $collection \
    --model_name $model_name --exp_id $exp_id \
    --distill_loss_decay exp \
    --double_branch --drop $drop --input_drop $input_drop \
    --q_feat_size $q_feat_size \
    --label_style $label_style "${@:2}"
