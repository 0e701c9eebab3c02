"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/<source>.cu` holds one or more kernels, each behind a plain C
entry point (no PyTorch headers, so `nvcc` takes seconds per file). A source
compiles for `sm_90a` into its own shared library under `build/kernels/` at
the repository root, named after a hash of its source, the shared
`csrc/*.cuh` headers and the flags, so an edited source rebuilds and an
unchanged one is reused. All sources build in
parallel, one `nvcc` each, the first time any kernel is launched. The
libraries load with `ctypes`.

Every C entry point returns `cudaGetLastError()` after its launch; `launch`
raises if that is not 0. Each `Kernel` keeps a plain integer count of its
launches, which a run can read to show that a path went through the kernel;
a lock keeps the count whole when a mesh's rank threads launch at once.

The wrappers in ops/ register their kernels as `torch.library` custom ops
in the `svc` namespace (`OPS`), each with a fake implementation, so that
`torch.export` can trace a model through them (models/export.py); the
op's implementation picks the kernel or the plain version by
`device_route`, and on the card the kernel by dtype and head dim (the
Hopper kernels take bf16, the fp32 entries fp32, K2's other entry every
head dim and dtype the Hopper K2 does not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class Kernel:
    """One kernel: its C entry point in a CUDA source (`csrc/<name>.cu`
    unless `source` names another) and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list, source: str | None = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = CSRC / f"{source or name}.cu"
        self.launches = 0
        self._fn = None

    def library(self) -> Path:
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def _load(self):
        if self._fn is None:
            with _LOCK:
                if self._fn is None:
                    lib_path = self.library()
                    if not lib_path.exists():
                        build_all()
                    lib = ctypes.CDLL(str(lib_path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = _I
                    err = lib.svc_error_string
                    err.argtypes = [_I]
                    err.restype = ctypes.c_char_p
                    self._err = err
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which enqueues the kernel on the given
        stream) and raise if the launch was refused."""
        fn = self._load()
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with CUDA error {code} "
                f"({self._err(code).decode()})"
            )
        with _COUNT_LOCK:  # a mesh's ranks launch from several threads
            self.launches += 1


_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()

# K1, K3 and K4 share one tile (csrc/flash_fwd_sm90.cuh) and one argument
# list: q, k, v, o, lse (fp32 (B, H, L) or null), B, H, L, the tensor-map
# byte strides (row, head, batch) of q, k and v, o's (batch, head, row)
# element strides, scale*log2(e), stream
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I] + [_LL] * 12 + [ctypes.c_float, _P]
FLASH_ATTENTION = Kernel("flash_attention", "svc_flash_attention_fwd", _FWD_ARGS)
FLASH_ATTENTION_BWD_DKV = Kernel(
    "flash_attention_bwd_dkv",
    "svc_flash_attention_bwd_dkv",
    # q, k, v, do, lse, delta, dk, dv, B, H, L, the tensor-map byte strides
    # (row, head, batch) of q, k, v and do, the (batch, head, row) element
    # strides of dk and dv, scale, stream
    [_P] * 8 + [_I, _I, _I] + [_LL] * 12 + [_LL] * 6 + [ctypes.c_float, _P],
    source="flash_attention_bwd",
)
FLASH_ATTENTION_BWD_DQ = Kernel(
    "flash_attention_bwd_dq",
    "svc_flash_attention_bwd_dq",
    # q, k, v, do, lse, delta, dq, B, H, L, the tensor-map byte strides of
    # q, k, v and do, dq's element strides, scale, stream
    [_P] * 7 + [_I, _I, _I] + [_LL] * 12 + [_LL] * 3 + [ctypes.c_float, _P],
    source="flash_attention_bwd",
)
TIME_ATTENTION = Kernel(
    "time_attention",
    "svc_time_attention_fwd",
    # q, k, v, o, b, T, H, S, then (frame, head, channel) strides of q, k, v,
    # o, scale*log2(e), key-frame ceiling, ring stages, copy granule, stream
    [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 12 + [ctypes.c_float, _I, _I, _I, _P],
)
FLASH_ATTENTION_BLHD = Kernel("flash_attention_blhd", "svc_flash_attention_blhd_fwd", _FWD_ARGS)
FLASH_ATTENTION_PACKED = Kernel("flash_attention_packed", "svc_flash_attention_packed_fwd", _FWD_ARGS)
# the fp32 entry of K1, K3 and K4 (csrc/flash_attention_fp32.cu): q, k, v, o,
# lse (fp32 (B, H, L) or null), B, H, L, the (batch, head, row, dim)
# element strides of q, k, v and o, scale*log2(e), stream
FLASH_ATTENTION_FP32 = Kernel(
    "flash_attention_fp32", "svc_flash_attention_fp32_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I] + [_LL] * 16 + [ctypes.c_float, _P],
)
# the fp32 entries of K1-dKV and K1-dQ (csrc/flash_attention_bwd_fp32.cu):
# q, k, v, do, lse, delta, the outputs, B, H, L, the (batch, head, row, dim)
# element strides of q, k, v and do, the outputs' (batch, head, row)
# element strides, scale, stream
FLASH_ATTENTION_BWD_DKV_FP32 = Kernel(
    "flash_attention_bwd_dkv_fp32", "svc_flash_attention_bwd_dkv_fp32",
    [_P] * 8 + [_I, _I, _I] + [_LL] * 16 + [_LL] * 6 + [ctypes.c_float, _P],
    source="flash_attention_bwd_fp32",
)
FLASH_ATTENTION_BWD_DQ_FP32 = Kernel(
    "flash_attention_bwd_dq_fp32", "svc_flash_attention_bwd_dq_fp32",
    [_P] * 7 + [_I, _I, _I] + [_LL] * 16 + [_LL] * 3 + [ctypes.c_float, _P],
    source="flash_attention_bwd_fp32",
)
# K2's entry for what the Hopper K2 does not take (csrc/time_attention_any.cu):
# q, k, v, o, b, T, H, D, S, the (frame, head, channel, position) element
# strides of q, k, v and o, scale*log2(e), dtype (0 fp32, 1 bf16, 2 fp16),
# key-frame ceiling, ring stages, copy mode, stream
TIME_ATTENTION_ANY = Kernel(
    "time_attention_any", "svc_time_attention_any_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 16 + [ctypes.c_float, _I, _I, _I, _I, _P],
)
LAYER_NORM = Kernel(
    "layer_norm",
    "svc_layer_norm_fwd",
    # x, gamma, beta, y, rows, C, dtype (0 bf16, 1 fp32), eps, rows per
    # tile, ring stages, stream
    [_P, _P, _P, _P, _LL, _I, _I, ctypes.c_float, _I, _I, _P],
)
KERNELS = {
    k.name: k
    for k in (FLASH_ATTENTION, FLASH_ATTENTION_BWD_DKV, FLASH_ATTENTION_BWD_DQ, TIME_ATTENTION,
              FLASH_ATTENTION_BLHD, FLASH_ATTENTION_PACKED, LAYER_NORM, FLASH_ATTENTION_FP32,
              FLASH_ATTENTION_BWD_DKV_FP32, FLASH_ATTENTION_BWD_DQ_FP32, TIME_ATTENTION_ANY)
}


def build_all() -> None:
    """Compile every source whose library is missing, one `nvcc` per source,
    all at once. Raises with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for k in KERNELS.values():
        out = k.library()
        if out.exists() or k.source.stem in procs:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs[k.source.stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (p, tmp, out) in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))


OPS = "svc"  # the torch.library namespace of the kernels' custom ops


def device_route(what: str, t) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel) for a tensor on that
    device; any other device raises, so nothing falls back to the plain
    version off the CPU."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise RuntimeError(f"{what} has no kernel for device {t.device}")


def reset_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}
