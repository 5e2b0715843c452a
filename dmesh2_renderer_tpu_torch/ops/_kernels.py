"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (the
compositors share ``csrc/pair_math.cuh``). At first use it is compiled with
``nvcc`` for ``sm_90a`` into ``csrc/build/`` (a directory git ignores), under
a name that hashes the source, the shared headers and the flags, and loaded
with ``ctypes``. Nothing is compiled at import time, so the CPU
tests import every module without a CUDA toolchain.

Each kernel object carries ``launches``, a count of its successful launches:
its wrapper calls :meth:`Kernel.launched` right after the C launch function
returns, and nowhere else. The peel's wide and deep instances, two more
kernels in ``peel.cu``, are counted apart (``PEEL_WIDE``, ``PEEL_DEEP``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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

    def __init__(self, name: str, source: str, argtypes, extra_flags=(),
                 companions=()):
        self.name = name
        self.source = CSRC / source
        self.argtypes = list(argtypes)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        # Kernels that every caller of this one also launches: built with it.
        self.companions = tuple(companions)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        # The name hashes the source, every header beside it and the flags.
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile with nvcc unless the library exists, and the companions
        at the same time; return the library's path.

        nvcc writes a temporary file that is then renamed, so an interrupted
        build never leaves a partial library behind; two threads that build
        one kernel take turns, and the second finds the library built.
        """
        if not self.companions:
            return self._build()
        with ThreadPoolExecutor(len(self.companions)) as pool:
            others = [pool.submit(k.build) for k in self.companions]
            out = self._build()
            for fut in others:
                fut.result()
        return out

    def _build(self) -> Path:
        with self._lock:
            return self._compile()

    def _compile(self) -> Path:
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

    def check(self, err: int, name: str | None = None) -> None:
        """Raise unless the launch function's ``cudaGetLastError()`` is 0."""
        if err != 0:
            msg = self._lib.cuda_error_string(err).decode()
            raise RuntimeError(f"{name or self.name} kernel launch failed: {msg} ({err})")

    def launched(self, err: int) -> None:
        """Check the launch function's ``cudaGetLastError()`` and count it."""
        self.check(err)
        self.launches += 1

    def occupancy(self, function: str | None = None, *args: int) -> dict:
        """The kernel's resources on the current card, from its
        ``<name>_occupancy`` C function (or ``function``, called with the
        int ``args`` first): registers per thread, static and dynamic shared
        memory and local (spill) bytes, and resident 256-thread blocks per
        SM (the peel's for its 8-slot instance)."""
        return self.query(function or f"{self.name}_occupancy", args,
                          ("registers", "static_smem", "dynamic_smem", "local_bytes",
                           "blocks_per_sm"))

    def query(self, function: str, args, keys) -> dict:
        """The ints the C function ``function`` writes, after the int
        ``args``, into an array of ``len(keys)``, by ``keys``; raises unless
        it returns 0."""
        lib = self.load()
        fn = getattr(lib, function)
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * len(keys))()
        err = fn(*args, out)
        if err != 0:
            msg = lib.cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} query {function} failed: {msg} ({err})")
        return dict(zip(keys, out))


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

# grad_reduce, the reduction of composite_bwd's per-entry records to the
# rasterizer's input gradients (its second kernel, the AA corners' backward,
# is CORNER_REDUCE below). It only adds, so no flag changes its rounding.
GRAD_REDUCE = Kernel("grad_reduce", "grad_reduce.cu", [
    P, L,                 # gradient records, R
    P, P, P, P, I,        # entry_bf, tile_starts, tile_counts, nc_tile, tiles
    P, I, I, I,           # faces, B, F, P
    P, P, P, P, P,        # d_vert8 (P, 8), d_op, d_vndc, d_int, d_aa
    P,                    # stream
])

# composite_bwd replays composite_fwd's blend and must take its decisions bit
# for bit: same shared header (pair_math.cuh), same flags. Its records go to
# grad_reduce, which is built with it.
COMPOSITE_BWD = Kernel("composite_bwd", "composite_bwd.cu", [
    P, L,                 # records, R
    P, P, P,              # tile_starts, tile_counts, nc_tile
    P, P, P, P,           # ray_o, ray_d, background, patch_min
    P, P, P, P,           # color, depth, final_t, prev_t
    P, P, P,              # g_color, g_depth, g_final_t
    I, I, I, I, I,        # B, H, W, gx, gy
    F, F,                 # tau, 1 - tau
    P, P,                 # out, stream
], extra_flags=("-fmad=false",), companions=(GRAD_REDUCE,))

# peel is built without FMA contraction so that its hit tests round every
# operation as its plain version does.
PEEL = Kernel("peel", "peel.cu", [
    P, L,                 # entry_bf, R
    P, P, P, I,           # faces, verts, faces_existence, F
    P, P, P, I,           # tile_starts, tile_counts, tile_ids (or null), n_blocks
    P, P,                 # ray_o, ray_d
    I, I, I, I,           # H, W, gx, gy
    I, I,                 # slot count (instantiation), layers written
    P, P,                 # layers, counts
    P,                    # stream
], extra_flags=("-fmad=false",))


# quad_map, the float32 rate calibration (utils/fp32_rate.py): one launch
# function for both its instances, uncontracted and contracted (the
# intrinsics fix each, whatever the flags; -fmad=false as for the others).
QUAD_MAP = Kernel("quad_map", "quad_map.cu", [
    P, L, I, I,           # x, n, iters, contract
    P, P,                 # out, stream
], extra_flags=("-fmad=false",))

# bin_emit, the binning's emission grid, is built without FMA contraction so
# that its triangle-vs-tile test rounds every operation as the plain
# version's eager ops do.
BIN_EMIT = Kernel("bin_emit", "bin_emit.cu", [
    P, P, P, P,           # aa_face_verts, depth01, alive, patch_min
    I, I, I, I, I, I, I,  # F, B*F, gx, gy, Kt, bits_d, exact tile cull
    P, P, I, I,           # giant rows' sorted keys and ids (or null), rows, cols
    L, L,                 # padding: first slot, slot count
    P, P, P, P, P,        # keys, payload, selection keys, giant_ids, counts
    P,                    # stream
], extra_flags=("-fmad=false",))


class Instance:
    """A second kernel of another :class:`Kernel`'s source, counted on its
    own. It is launched through the kernel's C launch function, or through
    the C function ``launch`` of that library with ``argtypes``."""

    def __init__(self, name: str, kernel: Kernel, launch: str | None = None,
                 argtypes=()):
        self.name = name
        self.kernel = kernel
        self.source = kernel.source
        self.launch = launch
        self.argtypes = list(argtypes)
        self.launches = 0

    def load(self):
        """The C launch function (the kernel's own when ``launch`` is None)."""
        lib = self.kernel.load()
        if self.launch is None:
            return getattr(lib, f"{self.kernel.name}_launch")
        fn = getattr(lib, self.launch)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launched(self, err: int) -> None:
        self.kernel.check(err, self.name)
        self.launches += 1


# peel.cu's tiered instances, one body built with two pairs of tiers (each
# pixel's first slots and list entries in shared memory, the rest in a
# global scratch): the wide instance (17 .. 96 slots) and the deep one
# (above), both launched through one C function that picks the tiers by the
# slot count, each counted apart from the other and from the register
# instances (1 .. 16 slots), which PEEL counts.
_TIERED_ARGTYPES = [
    P, L,                 # entry_bf, R
    P, P, P, I,           # faces, verts, faces_existence, F
    P, P, P, I,           # tile_starts, tile_counts, tile_ids (or null), n_blocks
    P, P,                 # ray_o, ray_d
    I, I, I, I,           # H, W, gx, gy
    I,                    # slot count = layers written
    P, P,                 # layers, counts
    P, I,                 # scratch, persistent blocks
    P,                    # stream
]
PEEL_WIDE = Instance("peel_wide", PEEL, "peel_tiered_launch", _TIERED_ARGTYPES)
PEEL_DEEP = Instance("peel_deep", PEEL, "peel_tiered_launch", _TIERED_ARGTYPES)

# grad_reduce.cu's second kernel: the AA corners' cotangent un-swapped and
# added onto the screen-space vertices (geometry.face_aa_verts_ccw's backward).
CORNER_REDUCE = Instance("corner_reduce", GRAD_REDUCE, "corner_reduce_launch", [
    P, P, P, L,           # g (B, F, 3, 2), neg (B, F), faces, corners B*F*3
    I, I,                 # F, P
    P, P,                 # d_image (B, P, 2), stream
])

KERNELS = (PACK_STREAM, COMPOSITE_FWD, COMPOSITE_BWD, PEEL, QUAD_MAP, BIN_EMIT,
           GRAD_REDUCE)
# Everything with a launch count: the built kernels, the peel's wide and
# deep ones and the corner reduction.
COUNTED = KERNELS + (PEEL_WIDE, PEEL_DEEP, CORNER_REDUCE)


def build_all() -> None:
    """Compile every kernel that is not built yet, all nvcc runs at once."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(Kernel.build, KERNELS))
    for k in KERNELS:
        k.load()


def check_inputs(device, specs) -> None:
    """Raise unless every tensor is on ``device``, of its dtype and shape,
    and contiguous, and ``device`` is a CUDA device (checked last, so that
    the rest can be tested on the meta device). ``specs``: (name, tensor,
    dtype, shape) tuples."""
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
    if device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got device {device}")


def check_aligned(name, t) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary (the
    compositors copy records with 16-byte cp.async)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def current_stream(device) -> ctypes.c_void_p:
    return P(torch.cuda.current_stream(device).cuda_stream)
