"""Device probe, kernel build and ctypes binding for the hand-written kernels.

The CUDA sources live in ``repro_torch/csrc/*.cu``. Each is compiled on first
use by its own ``nvcc`` process (all started together) into a shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

and loaded with ``ctypes``; nvcc's output (ptxas's register and spill report)
is kept beside it as ``<name>-<hash>.log``. No source includes PyTorch's
headers, so a build takes seconds. ``build/`` sits at the repository root and is git-ignored; the
file name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a stale library is never loaded.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0. The kernels
are written for Hopper (``sm_90a``): asking for them on any other card raises.

``LAUNCH_COUNTS`` counts real kernel launches by name. Each kernel wrapper
adds one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``chip_smoke.py`` resets the counts
before the path and reads them after). A count is one call of the wrapper's C
entry point (``segment_sum`` calls ``segment_sum.cu``'s once per level of
its grouping, which starts one CUDA kernel, or two where the level has a run
longer than a chunk: the chunks, then their fixed-order sum; the entry point
counts the CUDA kernels it starts, one at each launch, and the wrapper adds
them to ``CUDA_KERNEL_COUNTS``);
``dequant_matmul`` (partial tiles, then their fixed-order sum) starts two
CUDA kernels per count; ``topk_score`` and ``coarse_topm`` two at
k <= 128 (the scan, then the row merge; one where each query tile is one
run) and 1 + ceil(log2(ceil(n_items / 128))) above (the scan, then merge
rounds), as their planner (``csrc/topk_select.cuh:make_plan``) says.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["DeviceInfo", "KernelCost", "probe", "sources_hash",
           "resolve_device", "require_sm90",
           "full_fp32", "build", "build_log",
           "lib_path", "kernel_fn", "launch", "stream_of", "check_cuda",
           "LAUNCH_COUNTS", "CUDA_KERNEL_COUNTS",
           "count_launch", "reset_counts", "SOURCES", "CSRC", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant_pack", "spmm", "topk_score", "sddmm", "dequant_matmul",
           "coarse_topm", "dequant_unpack", "segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCH_COUNTS: collections.Counter = collections.Counter()
CUDA_KERNEL_COUNTS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}


def count_launch(name: str, kernels: int | None = None) -> None:
    """One launch of ``name``'s kernel; ``kernels``, where the C entry point
    reports how many CUDA kernels it started, adds to
    ``CUDA_KERNEL_COUNTS``."""
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1
        if kernels is not None:
            CUDA_KERNEL_COUNTS[name] += kernels


def reset_counts() -> None:
    with _COUNT_LOCK:
        LAUNCH_COUNTS.clear()
        CUDA_KERNEL_COUNTS.clear()


class KernelCost(collections.namedtuple("KernelCost",
                                         "flops bytes peak")):
    """The work of one call of a hand-written kernel, from its shapes (each
    kernel module's ``*_cost``): ``flops`` operations, ``bytes`` moved with
    each input read once and each output written once, and ``peak`` the
    rate they run at (``"fp32"``, ``"bf16"`` or ``"int8"``: a key of
    ``launch.roofline``'s profiles, ``peak_<peak>``). ``chip_smoke.py``'s
    bound column and ``launch.roofline.trace_step`` count with them."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    name: str
    capability: tuple[int, int]
    count: int

    @property
    def fingerprint(self) -> str:
        """What a measured tile choice depends on (``kernels.autotune``'s
        cache key): the card's name and capability, the CUDA runtime and
        torch versions, and a hash of the kernel sources."""
        return (f"{self.name}|sm_{self.capability[0]}{self.capability[1]}|"
                f"cuda {torch.version.cuda}|torch {torch.__version__}|"
                f"src {sources_hash()}")


def probe() -> DeviceInfo:
    """Name, compute capability and count of the visible CUDA devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    return DeviceInfo(name=torch.cuda.get_device_name(0),
                      capability=tuple(torch.cuda.get_device_capability(0)),
                      count=torch.cuda.device_count())


@functools.lru_cache(maxsize=1)
def sources_hash() -> str:
    """A hash of every kernel source (``csrc/*.cu`` and ``*.cuh``)."""
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    there is no silent CPU run; pass ``device="cpu"`` for the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is false; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


@functools.lru_cache(maxsize=None)
def _capability(index) -> tuple[int, int]:
    return tuple(torch.cuda.get_device_capability(index))


def require_sm90(device: torch.device) -> None:
    cap = _capability(device.index)
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")


@contextlib.contextmanager
def full_fp32():
    """Run the block's float32 matmuls in full fp32 (no TF32), as XLA does,
    and give the caller back its own setting afterwards: the flag
    ``torch.backends.cuda.matmul.allow_tf32`` is process-wide."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = before


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (content-hashed)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler output (ptxas's register and spill report) kept beside
    the library built from ``csrc/<name>.cu``; "" if there is none."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, str]:
    """Compile every missing library of ``names``, one ``nvcc`` each, all
    started together; returns each build's compiler output ("" when the
    library was already built; ``build_log`` reads it back). Raises with the
    compiler's output on failure. A file lock in the build directory keeps
    processes that build at once (the ranks of a multi-rank run) from
    compiling the same library twice."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _BUILD_LOCK, open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        logs = {}
        for name in names:
            out = lib_path(name)
            if out.exists() and out.with_suffix(".log").exists():
                logs[name] = ""
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            logs[name] = text
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                out.with_suffix(".log").write_text(text)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build(SOURCES)
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def kernel_fn(lib_name: str, fn_name: str, argtypes):
    """The C entry point ``fn_name`` of library ``lib_name`` with its
    argument types declared (``c_void_p`` for every pointer and the stream,
    so ctypes never cuts a 64-bit address); bound once, then cached."""
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(_library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(fn, *args) -> None:
    """Call a C entry point and raise if it reports a CUDA error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def check_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str):
    """Validate what a kernel takes before its pointer crosses into C."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
