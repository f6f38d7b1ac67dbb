"""Measure the fused attention kernel families on this card and cache the
pick (``tools/autotune.py``):

  python tools/autotune_torch.py [--refresh] [--trainable-only] [--cache PATH]

Prints one JSON line: the card's name and power limit, each family's time
through a Swin block's attention half at the flagship stage-0 geometry
(``vadcl_tpu_torch/utils/autotune.py``), and the pick, which is cached per
kind of card (default ``~/.cache/vadcl_tpu_torch/autotune.json``).  Where
the cache already holds a pick for this card and ``--trainable-only``,
that pick and the times it was made from are printed (``from_cache``) and
nothing is measured; ``--refresh`` measures anyway and rewrites the entry.
``--attn-kernel auto`` in ``tools/train_torch.py`` and
``tools/evaluate_torch.py`` stays the fixed choice (``fold`` with
``--fused``); pass the printed pick to use the measured one.  Without a
card it prints the pick ``base`` and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from vadcl_tpu_torch.utils.autotune import (
    DEFAULT_CACHE,
    cache_key,
    read_cache,
    tuned_attn_kernel,
)
from vadcl_tpu_torch.utils.provenance import smi_line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--refresh", action="store_true", help="re-measure even if cached")
    ap.add_argument("--trainable-only", action="store_true",
                    help="leave out the inference-only families (packed, fold_packed)")
    ap.add_argument("--cache", default=None, help="the cache file (JSON)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print(json.dumps({"pick": "base", "note": "no CUDA device: nothing measured"}))
        return "base"
    path, key = args.cache or DEFAULT_CACHE, cache_key(args.trainable_only)
    entry = read_cache(path).get(key)
    cached = not args.refresh and isinstance(entry, dict) and "pick" in entry
    pick = tuned_attn_kernel(trainable_only=args.trainable_only, cache_path=path,
                             refresh=args.refresh)
    times = read_cache(path)[key].get("times_s", {})
    print(json.dumps({
        "device": torch.cuda.get_device_name(), "nvidia_smi": smi_line(),
        "times_ms": {k: v * 1e3 for k, v in times.items()}, "from_cache": cached,
        "pick": pick, "trainable_only": args.trainable_only,
    }))
    return pick


if __name__ == "__main__":
    main()
