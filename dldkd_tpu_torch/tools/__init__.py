"""Tools: `tower_variants.py` (the tower kernels' variants on the card, run as
a script), `train_bench` (the train step by stage,
`python -m dldkd_tpu_torch.tools.train_bench`) and `extract_teacher` (CLIP
teacher features, `python -m dldkd_tpu_torch.tools.extract_teacher`) with
its `clip_tokenizer` and `clip_preprocess`."""
