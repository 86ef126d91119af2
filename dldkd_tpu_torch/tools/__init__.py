"""Tools: `tower_variants.py` (the tower kernels' variants on the card, run as
a script) and `train_bench` (the train step by stage,
`python -m dldkd_tpu_torch.tools.train_bench`)."""
