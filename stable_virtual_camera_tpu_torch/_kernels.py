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
launches, which a run can read to show that a path went through the kernel.
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
        self.launches += 1


_LOCK = threading.RLock()

FLASH_ATTENTION = Kernel(
    "flash_attention",
    "svc_flash_attention_fwd",
    # q, k, v, o, lse (fp32 (B, H, L) or null), B, H, L, then (batch, head,
    # row) strides of q, k, v, o, scale*log2(e), stream
    [_P, _P, _P, _P, _P, _I, _I, _I] + [_LL] * 12 + [ctypes.c_float, _P],
)
FLASH_ATTENTION_BWD_DKV = Kernel(
    "flash_attention_bwd_dkv",
    "svc_flash_attention_bwd_dkv",
    # q, k, v, do, lse, delta, dk, dv, B, H, L, then (batch, head, row)
    # strides of q, k, v, do, dk, dv, scale, stream
    [_P] * 8 + [_I, _I, _I] + [_LL] * 18 + [ctypes.c_float, _P],
    source="flash_attention_bwd",
)
FLASH_ATTENTION_BWD_DQ = Kernel(
    "flash_attention_bwd_dq",
    "svc_flash_attention_bwd_dq",
    # q, k, v, do, lse, delta, dq, B, H, L, then (batch, head, row) strides
    # of q, k, v, do, dq, scale, stream
    [_P] * 7 + [_I, _I, _I] + [_LL] * 15 + [ctypes.c_float, _P],
    source="flash_attention_bwd",
)
TIME_ATTENTION = Kernel(
    "time_attention",
    "svc_time_attention_fwd",
    # q, k, v, o, b, T, H, S, then (frame, head, channel) strides of q, k, v,
    # o, scale, stream
    [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 12 + [ctypes.c_float, _P],
)
FLASH_ATTENTION_BLHD = Kernel(
    "flash_attention_blhd",
    "svc_flash_attention_blhd_fwd",
    # q, k, v, o (contiguous (B, L, H, 64)), B, H, L, then (batch, row, head)
    # strides of q, k, v, scale*log2(e), stream
    [_P, _P, _P, _P, _I, _I, _I] + [_LL] * 9 + [ctypes.c_float, _P],
)
FLASH_ATTENTION_PACKED = Kernel(
    "flash_attention_packed",
    "svc_flash_attention_packed_fwd",
    # q, k, v, o (contiguous (B, L, H*64)), B, H, L, then (batch, row)
    # strides of q, k, v, scale*log2(e), stream
    [_P, _P, _P, _P, _I, _I, _I] + [_LL] * 6 + [ctypes.c_float, _P],
)
LAYER_NORM = Kernel(
    "layer_norm",
    "svc_layer_norm_fwd",
    # x, gamma, beta, y, rows, C, dtype (0 bf16, 1 fp32), eps, stream
    [_P, _P, _P, _P, _LL, _I, _I, ctypes.c_float, _P],
)
KERNELS = {
    k.name: k
    for k in (FLASH_ATTENTION, FLASH_ATTENTION_BWD_DKV, FLASH_ATTENTION_BWD_DQ, TIME_ATTENTION,
              FLASH_ATTENTION_BLHD, FLASH_ATTENTION_PACKED, LAYER_NORM)
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


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}
