"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (the
compositors share ``csrc/pair_math.cuh``). At first use it is compiled with
``nvcc`` for ``sm_90a`` into ``csrc/build/`` (a directory git ignores), under
a name that hashes the source, the shared headers and the flags, and loaded
with ``ctypes``. Nothing is compiled at import time, so the CPU
tests import every module without a CUDA toolchain.

Each kernel object carries ``launches``, a count of its successful launches:
its wrapper calls :meth:`Kernel.launched` right after the C launch function
returns, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

# No --use_fast_math: approximate reciprocals would move the AA area and the
# barycentric clamp's region codes away from the plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from source at first use")
    return found


class Kernel:
    """One CUDA source file, its build, its C launch function and its count."""

    def __init__(self, name: str, source: str, argtypes, extra_flags=()):
        self.name = name
        self.source = CSRC / source
        self.argtypes = list(argtypes)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        # The name hashes the source, every shared header and the flags.
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile with nvcc unless the library exists; return its path.

        nvcc writes a temporary file that is then renamed, so an interrupted
        build never leaves a partial library behind.
        """
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {proc.returncode}):"
                f"\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launched(self, err: int) -> None:
        """Check the launch function's ``cudaGetLastError()`` and count it."""
        if err != 0:
            msg = self._lib.cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({err})")
        self.launches += 1


PACK_STREAM = Kernel("pack_stream", "pack_stream.cu", [
    P, L,                 # entry_bf, R
    P, P, P, P, P, P, P,  # faces, verts, verts_color, verts_ndc, opacity,
                          # intense, aa_face_verts
    I, I, I,              # B, F, P
    P, P,                 # out, stream
])

# composite_fwd is built without FMA contraction so that it rounds every
# operation as its plain version does (see the note in its source).
COMPOSITE_FWD = Kernel("composite_fwd", "composite_fwd.cu", [
    P, L,                 # records, R
    P, P,                 # tile_starts, tile_counts
    P, P, P, P,           # ray_o, ray_d, background, patch_min
    I, I, I, I, I,        # B, H, W, gx, gy
    F, F,                 # tau, 1 - tau
    P, P, P, P, P, P,     # color, depth, final_t, prev_t, n_contrib, nc_tile
    P,                    # stream
], extra_flags=("-fmad=false",))

# composite_bwd replays composite_fwd's blend and must take its decisions bit
# for bit: same shared header (pair_math.cuh), same flags.
COMPOSITE_BWD = Kernel("composite_bwd", "composite_bwd.cu", [
    P, L,                 # records, R
    P, P, P,              # tile_starts, tile_counts, nc_tile
    P, P, P, P,           # ray_o, ray_d, background, patch_min
    P, P, P, P,           # color, depth, final_t, prev_t
    P, P, P,              # g_color, g_depth, g_final_t
    I, I, I, I, I,        # B, H, W, gx, gy
    F, F,                 # tau, 1 - tau
    P, P,                 # out, stream
], extra_flags=("-fmad=false",))

KERNELS = (PACK_STREAM, COMPOSITE_FWD, COMPOSITE_BWD)


def build_all() -> None:
    """Compile every kernel that is not built yet, all nvcc runs at once."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(Kernel.build, KERNELS))
    for k in KERNELS:
        k.load()


def check_inputs(device, specs) -> None:
    """Raise unless every tensor is on ``device``, of its dtype and shape,
    and contiguous. ``specs``: (name, tensor, dtype, shape) tuples."""
    if device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got device {device}")
    for name, t, dtype, shape in specs:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def current_stream(device) -> ctypes.c_void_p:
    return P(torch.cuda.current_stream(device).cuda_stream)
