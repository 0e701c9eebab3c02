"""Read a torch.profiler Chrome trace into device time by kernel class.

Counterpart of stable_virtual_camera_tpu/utils/trace_analysis.py, for the
traces `utils/profiling.trace` writes: the device's work is the kernel,
memcpy and memset events of the GPU processes (one process per card, one
thread per stream). Kernels are bucketed by name into the classes of
`KERNEL_CLASSES`: the port's hand-written kernels (K1 to K5 and the
backward pair) by their entry points, then the library kernels.

Usage:
    with profiling.trace("trace_dir"):
        ... one step ...
    python -m stable_virtual_camera_tpu_torch.utils.trace_analysis trace_dir [--fusions] [--instances]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys

# (class, pattern searched in the kernel's name), first match wins
KERNEL_CLASSES: list[tuple[str, str]] = [
    ("int8 GEMM (cuBLASLt)", r"(?i)(gemm|xmma|nvjet|cutlass).*(s8|i8|imma)|(s8|i8|imma).*gemm"),
    ("K1 flash attention", r"flash_fwd_kernel"),
    ("K1-dKV", r"flash_bwd_dkv_kernel"),
    ("K1-dQ", r"flash_bwd_dq_kernel"),
    ("K2 temporal attention", r"time_attn_kernel"),
    ("K3 flash attention", r"flash_blhd_kernel"),
    ("K4 flash attention", r"flash_packed_kernel"),
    ("K5 layer norm", r"^void \(anonymous namespace\)::layer_norm_kernel<"),
    ("convolution (cuDNN)", r"conv|Conv|cudnn|dgrad|wgrad|fprop|implicit"),
    ("GEMM (cuBLAS)", r"gemm|Gemm|cutlass|xmma|nvjet|sm90_|sm80_"),
    ("optimizer", r"multi_tensor|adam|Adam|foreach"),
    ("reductions", r"reduce|Reduce|norm"),
    ("elementwise and copies", r"elementwise|Elementwise|vectorized|CatArray|copy|fill|index|Memcpy|Memset"),
]
_COMPILED = [(c, re.compile(rx)) for c, rx in KERNEL_CLASSES]
# the trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(logdir: str) -> list[dict]:
    """The events of the newest `*.pt.trace.json[.gz]` under `logdir`."""
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json*"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {logdir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_events(events: list[dict]) -> list[dict]:
    """Complete events of device work in the GPU processes (those whose
    name or label says "GPU n"; a GPU-side annotation range shares the
    process, so the category picks the work)."""
    gpu_pids = {
        e["pid"]
        for e in events
        if e.get("ph") == "M" and e.get("name") in ("process_name", "process_labels")
        and any(re.search(r"\bGPU\b", str(v)) for v in e.get("args", {}).values())
    }
    return [
        e
        for e in events
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES
        and e.get("pid") in gpu_pids
    ]


def categorize(name: str) -> str:
    """The class of a device kernel, from its name (the JAX version also
    reads the HLO arguments, which a CUDA kernel has none of)."""
    return next((c for c, rx in _COMPILED if rx.search(name)), "other")


def class_totals(logdir: str) -> dict[str, float]:
    """Device time by class (ms), largest first."""
    by_cat: collections.Counter = collections.Counter()
    for e in device_events(load_trace(logdir)):
        by_cat[categorize(e.get("name", "?"))] += e["dur"] / 1e3
    return dict(by_cat.most_common())


def summarize(logdir: str, top: int = 20) -> str:
    by_op: collections.Counter = collections.Counter()
    for e in device_events(load_trace(logdir)):
        by_op[re.sub(r"\d+", "#", e.get("name", "?"))[:100]] += e["dur"]
    lines = ["-- by category (ms) --"]
    lines += [f"{ms:9.2f}  {cat}" for cat, ms in class_totals(logdir).items()]
    lines.append("-- top ops (ms) --")
    for op, dur in by_op.most_common(top):
        lines.append(f"{dur / 1e3:9.2f}  {op}")
    return "\n".join(lines)


def _launch(e: dict) -> str:
    args = e.get("args", {})
    return f"grid {args.get('grid', '?')} block {args.get('block', '?')}"


def top_fusion_details(logdir: str, top: int = 10) -> str:
    """The most expensive kernels by name, each with the launch grid and
    block of its longest launch (from the trace's event arguments). The
    JAX version lists XLA fusions with their HLO; a CUDA trace has no
    fusions, and a kernel's grid is what tells its shapes apart."""
    per_op: collections.Counter = collections.Counter()
    longest: dict[str, dict] = {}
    for e in device_events(load_trace(logdir)):
        name = e.get("name", "?")
        per_op[name] += e["dur"]
        if name not in longest or e["dur"] > longest[name]["dur"]:
            longest[name] = e
    lines = ["-- top kernels with their longest launch (total ms) --"]
    for op, dur in per_op.most_common(top):
        lines.append(f"{dur / 1e3:9.2f}  {op[:200]}\n           {_launch(longest[op])}")
    return "\n".join(lines)


def instances(logdir: str, top: int = 40, name_filter: str = "") -> str:
    """Device time by kernel launch configuration (name, grid, block), not
    aggregated over shapes: which shapes of a class dominate it. Repeated
    launches of one configuration are summed."""
    per_instr: collections.Counter = collections.Counter()
    for e in device_events(load_trace(logdir)):
        name = e.get("name", "?")
        if name_filter and name_filter not in name:
            continue
        per_instr[(name, _launch(e))] += e["dur"]
    lines = [f"-- top {top} kernel instances (ms) --"]
    for (op, launch), dur in per_instr.most_common(top):
        lines.append(f"{dur / 1e3:8.2f}  {op[:200]}\n          {launch}")
    return "\n".join(lines)


if __name__ == "__main__":
    dirs = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(dirs) != 1:
        sys.exit("usage: python -m stable_virtual_camera_tpu_torch.utils.trace_analysis "
                 "TRACE_DIR [--fusions] [--instances]")
    logdir = dirs[0]
    print(summarize(logdir))
    if "--fusions" in sys.argv:
        print(top_fusion_details(logdir))
    if "--instances" in sys.argv:
        print(instances(logdir, top=50))
