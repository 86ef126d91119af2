"""Tools: `tower_variants.py` (the tower kernels' variants on the card, run as
a script), `train_bench` (the train step by stage,
`python -m dldkd_tpu_torch.tools.train_bench`) and `extract_teacher` (CLIP
teacher features, `python -m dldkd_tpu_torch.tools.extract_teacher`) with
its `clip_tokenizer` and `clip_preprocess`; the serving benches
`stage_bench`, `search_bench`, `stream_bench` and `coldstart_bench`, and
`bench` (one JSON line with the root bench.py's keys), each run as
`python -m dldkd_tpu_torch.tools.<name>`, with their shared workload in
`workload`."""
