"""The benchmark's cells at a size the CPU runs in a second: every width
cut, the files' other settings kept."""

from benchmark import harness

TINY_MODEL = dict(visual_input_size=48, query_input_size=40,
                  inheritance_hidden=16, exploration_hidden=16, max_ctx_l=12,
                  max_desc_l=6, teacher_size=20)


def tiny_cell(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    cfg = dict(c.config, **TINY_MODEL)
    if "n_videos" in cfg:
        cfg.update(n_videos=13, n_queries=31, eval_context_bsz=5,
                   eval_query_bsz=7)
    else:
        cfg.update(n_train_videos=24, bsz=8, n_train_split=100)
    mix = dict(c.mix, video_frames=[3, 12], query_tokens=[2, 6])
    return harness.Cell(c.name, c.chips, cfg, mix, c.params, c.end_to_end,
                        c.per_layer)
