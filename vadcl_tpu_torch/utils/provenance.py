"""Run-provenance stamping: resolved config + code version + argv.

The reference stamps every run with the git SHA/branch/dirty-state and the
full argument list at launch (``utils/distritributed_model.py:82-100``
``get_sha()``, printed plus ``主要框架.py:166-168`` dumping ``vars(args)``),
so a checkpoint directory can always be traced to the exact code and
configuration that produced it.  ``write_run_stamp`` writes
``run_meta.json`` into the output directory at train start with

* the fully-resolved ``Config`` tree (every default made explicit),
* git SHA + branch + dirty flag of the repository containing this package
  (best-effort: absent when not running from a git checkout),
* ``sys.argv``, the torch and CUDA versions, and the device topology (the
  CUDA device's name and count, or ``"cpu"`` with count 0),
* wall-clock start time.

The same keys as the JAX package's stamp, of which this is the port's own
copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional


def git_info(repo_dir: Optional[str] = None) -> Dict[str, Any]:
    """SHA / branch / dirty of the git checkout containing ``repo_dir``
    (default: this package).  Mirrors ``get_sha()``
    (``utils/distritributed_model.py:82-100``) including its swallow-errors
    behavior: fields degrade to "N/A" outside a checkout."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    info = {"sha": "N/A", "branch": "N/A", "dirty": None}

    def _run(*args: str) -> str:
        return subprocess.check_output(
            ["git", *args], cwd=repo_dir, stderr=subprocess.DEVNULL
        ).decode().strip()

    try:
        info["sha"] = _run("rev-parse", "HEAD")
        info["branch"] = _run("rev-parse", "--abbrev-ref", "HEAD")
        info["dirty"] = bool(_run("status", "--porcelain"))
    except Exception:
        pass
    return info


def resolved_config(cfg: Any) -> Any:
    """A JSON-safe dict of the full config tree with every default explicit."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {
            f.name: resolved_config(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, (list, tuple)):
        return [resolved_config(v) for v in cfg]
    if isinstance(cfg, dict):
        return {str(k): resolved_config(v) for k, v in cfg.items()}
    if isinstance(cfg, (str, int, float, bool)) or cfg is None:
        return cfg
    return repr(cfg)


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (the first card's line): written
    beside every time measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def topology(device: Any = None) -> Dict[str, Any]:
    """The devices a run sees: on a CUDA ``device`` the card's name and the
    visible card count, else ``"cpu"`` with count 0; and the number of
    processes of its data-parallel group (1 without one)."""
    import torch

    from vadcl_tpu_torch.core.mesh import process_count

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
                "device_count": torch.cuda.device_count(), "process_count": process_count()}
    return {"backend": "cpu", "device": "cpu", "device_count": 0,
            "process_count": process_count()}


def write_run_stamp(output_dir: str, cfg: Any, extra: Optional[Dict[str, Any]] = None,
                    device: Any = None) -> Optional[str]:
    """Write ``run_meta.json`` into ``output_dir``; returns the path.  Never
    raises — provenance must not be able to kill a training run."""
    try:
        import torch

        meta = {
            "config": resolved_config(cfg),
            "git": git_info(),
            "argv": list(sys.argv),
            "versions": {"torch": torch.__version__, "cuda": torch.version.cuda},
            "topology": topology(device),
            "start_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        }
        if extra:
            meta.update(extra)
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "run_meta.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, default=repr)
        os.replace(tmp, path)
        return path
    except Exception as e:  # pragma: no cover - best-effort by contract
        print(f"run-provenance stamp failed: {e!r}", file=sys.stderr)
        return None
