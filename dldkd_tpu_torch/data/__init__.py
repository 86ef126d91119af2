from dldkd_tpu_torch.data.bigfile import BigFile, BigFileWriter
from dldkd_tpu_torch.data.ingest import (
    PackedQueries,
    PackedVideos,
    dataset_paths,
    l2_normalize_rows,
    load_captions,
    pack_query_rows,
    pack_query_set,
    pack_video_corpus,
    read_dict,
    read_video_ids,
    uniform_feature_sampling,
)

__all__ = [
    "BigFile",
    "BigFileWriter",
    "PackedQueries",
    "PackedVideos",
    "dataset_paths",
    "l2_normalize_rows",
    "load_captions",
    "pack_query_rows",
    "pack_query_set",
    "pack_video_corpus",
    "read_dict",
    "read_video_ids",
    "uniform_feature_sampling",
]
