"""Long-horizon staged cluster-center training experiment on the PyTorch +
CUDA port (the port's ``tools/center_training_experiment.py``).

The reference's training regime: recon-only warmup, then the cluster
losses, center training and the compactness decode all engage at one staged
iteration (``main_predict.py:244-257``), the cluster-loss weight from the
author's working range 1e4-2e4 (``实验小笔记.txt:2``), on the latent-anomaly
fixture (``data/synthetic.py:make_latent_anomaly_dataset``) with centers
trained from their random init.  After each leg it prints one JSON line:
the AUC with the plain decode, and past the warmup the AUC with the
compactness decode and the codebook's occupancy (share of centers used,
share of the most used).

    EXP_W=10000 EXP_K=256 EXP_ALPHA=16 EXP_LEGS='[300, 1500, 3000, 6000]' \\
        python tools/center_training_experiment_torch.py

``EXP_DEVICE`` picks the device: ``cuda`` (the default; fp32, as the JAX
script runs) or ``cpu``, where a few short legs (``EXP_WARMUP=2
EXP_LEGS='[2, 4]'``) run in seconds.  Each leg resumes from the newest
checkpoint (``save_every_iters`` is the warmup).
"""
import dataclasses
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from vadcl_tpu_torch.core.config import (
    ClusterConfig,
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    ScheduleConfig,
)
from vadcl_tpu_torch.data import ClipDataset, HostDataLoader
from vadcl_tpu_torch.data.synthetic import make_latent_anomaly_dataset
from vadcl_tpu_torch.eval.predict import evaluate_videos, make_video_scorer
from vadcl_tpu_torch.models import VADModel
from vadcl_tpu_torch.train.loop import train

SIZE = 32
WARMUP = int(os.environ.get("EXP_WARMUP", "300"))
LEGS = json.loads(os.environ.get("EXP_LEGS", "[300, 1500, 3000, 6000]"))
W = float(os.environ.get("EXP_W", "10000.0"))
K = int(os.environ.get("EXP_K", "256"))
ALPHA = float(os.environ.get("EXP_ALPHA", "16.0"))
SEED = int(os.environ.get("EXP_SEED", "0"))
DEVICE = os.environ.get("EXP_DEVICE", "cuda")


def with_weights(config, trained):
    """A model of ``config`` holding ``trained``'s weights, for scoring."""
    model = VADModel(config, torch.float32).to(DEVICE)
    model.load_state_dict(trained.state_dict())
    return model.eval()


def run_eval(model, test_ds):
    scorer = make_video_scorer(lambda c: model(c).recon, 4, predict=False, batch_windows=8,
                               device=DEVICE)
    auc, _, _ = evaluate_videos(scorer, test_ds.iter_test_videos(), frame_num=4,
                                predict=False, protocol="nonoverlap")
    return auc


def occupancy(model, ds):
    harvest = np.linspace(0, len(ds) - 1, 16).astype(int)
    clips = torch.from_numpy(np.stack([ds.get_clip(int(i)) for i in harvest])).float() / 255.0
    with torch.inference_mode():
        out = model(clips[:8].to(DEVICE))
    assign = out.cluster_assign.float().cpu().numpy().reshape(-1, K)
    hist = np.bincount(assign.argmax(-1), minlength=K)
    return float(np.mean(hist > 0)), float(hist.max()) / float(hist.sum())


def main():
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("EXP_DEVICE=cuda: no CUDA device is visible; set EXP_DEVICE=cpu")
    root = tempfile.mkdtemp(prefix="center_long_")
    train_dir, test_dir, label_dir = make_latent_anomaly_dataset(
        root, num_train_videos=4, num_test_videos=2, frames_per_video=32, size=SIZE)
    test_ds = ClipDataset(test_dir, frame_num=4, size=(SIZE, SIZE), label_root=label_dir,
                          istest=True)

    mc = ModelConfig(
        embed_dim=32, encoder_depths=(1, 1), encoder_heads=(2, 4),
        decoder_depths=(1, 1), decoder_heads=(4, 2), use_cluster=True, compactness=True,
        cluster=ClusterConfig(feature_clusters=K, feature_alpha=ALPHA, space_clusters=8,
                              space_size=SIZE // 8),
    )
    mc_plain = dataclasses.replace(mc, compactness=False)
    schedule = ScheduleConfig(
        cluster_start_iter=WARMUP, cluster_train_start_iter=WARMUP,
        compactness_start_iter=WARMUP, cluster_weight=W, space_weight=0.0,
    )
    ds = ClipDataset(train_dir, frame_num=4, size=(SIZE, SIZE))
    steps_per_epoch = -(-len(ds) // 8)
    epochs = LEGS[-1] // steps_per_epoch + 2
    cfg = Config(
        model=mc,
        data=DataConfig(frame_num=4, image_size=(SIZE, SIZE)),
        optim=OptimConfig(lr=3e-4, min_lr=1e-5, epochs=epochs),
        schedule=schedule,
        batch_size_per_device=8,
        output_dir=os.path.join(root, "run"),
        save_every_epochs=0,
        save_every_iters=WARMUP,
        bf16=False,  # fp32 on the card, as the JAX script
        seed=SEED,
    )
    loader = HostDataLoader(ds, batch_size=8, seed=SEED, num_workers=2)
    for leg in LEGS:
        state = train(cfg, loader, max_steps=leg, device=DEVICE)
        plain = with_weights(mc_plain, state.model)
        rec = {"step": leg, "w": W, "K": K, "alpha": ALPHA, "seed": SEED,
               "auc_plain_decode": round(run_eval(plain, test_ds), 4)}
        if leg > WARMUP:
            compact = with_weights(mc, state.model)
            rec["auc_compact_decode"] = round(run_eval(compact, test_ds), 4)
            used, top1 = occupancy(compact, ds)
            rec["occ_used"], rec["occ_top1"] = round(used, 4), round(top1, 4)
        print(json.dumps(rec), flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
