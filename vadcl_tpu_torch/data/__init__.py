from vadcl_tpu_torch.data.dataset import ClipDataset, TestVideo, load_clip, load_video
from vadcl_tpu_torch.data.loader import HostDataLoader
from vadcl_tpu_torch.data.synthetic import make_latent_anomaly_dataset, make_synthetic_dataset

__all__ = [
    "ClipDataset",
    "HostDataLoader",
    "TestVideo",
    "load_clip",
    "load_video",
    "make_latent_anomaly_dataset",
    "make_synthetic_dataset",
]
