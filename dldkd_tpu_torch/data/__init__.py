from dldkd_tpu_torch.data.bigfile import BigFile, BigFile16, BigFileWriter
from dldkd_tpu_torch.data.ingest import (
    PackedQueries,
    PackedVideos,
    TrainData,
    dataset_paths,
    l2_normalize_rows,
    load_captions,
    pack_query_rows,
    pack_query_set,
    pack_train_dataset,
    pack_video_corpus,
    read_dict,
    read_video_ids,
    uniform_feature_sampling,
)
from dldkd_tpu_torch.data.pipeline import TrainLoader, device_prefetch

__all__ = [
    "BigFile",
    "BigFile16",
    "BigFileWriter",
    "PackedQueries",
    "PackedVideos",
    "TrainData",
    "TrainLoader",
    "dataset_paths",
    "device_prefetch",
    "l2_normalize_rows",
    "load_captions",
    "pack_query_rows",
    "pack_query_set",
    "pack_train_dataset",
    "pack_video_corpus",
    "read_dict",
    "read_video_ids",
    "uniform_feature_sampling",
]
