"""Builds the hand-written CUDA kernels from ``devicekmc_tpu_torch/csrc`` and
loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/devicekmc_tpu_torch/``
at the root of the checkout (a user cache directory for an installed
package, see :func:`_build_dir`), named by a hash of its source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when the package is imported: the
first kernel call builds what it needs, and :func:`build` compiles several
sources in parallel (one ``nvcc`` each).  :func:`tickets` holds the integer
tickets of the kernels that reduce across blocks in one launch
(``csrc/ticket.cuh``), and :func:`launch_counts` the counters on the card
of the kernels a captured superstep launches (``csrc/launch_count.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    """``build/devicekmc_tpu_torch`` of the checkout when the package runs
    from its source tree; for an installed package, a directory under
    ``$TORCH_EXTENSIONS_DIR`` or else ``~/.cache``."""
    root = Path(__file__).resolve().parents[2]
    if (root / "setup.py").exists():
        return root / "build" / "devicekmc_tpu_torch"
    base = os.environ.get("TORCH_EXTENSIONS_DIR") or Path.home() / ".cache"
    return Path(base) / "devicekmc_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and shared-memory report) per built source;
#: kept beside the library too (:func:`build_log`), since ptxas reports only
#: while it compiles
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu``: of this process's build, else
    as kept beside a library that an earlier process built ("" if neither)."""
    if name not in build_logs:
        kept = _log_path(_lib_path(name))
        build_logs[name] = kept.read_text() if kept.exists() else ""
    return build_logs[name]


def kernel_resources(name: str) -> Dict[str, tuple]:
    """{mangled kernel name: (registers, static shared bytes)} of
    ``csrc/<name>.cu`` from ptxas's report."""
    out, cur = {}, None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and cur:
            out[cur] = (int(m.group(1)), int(m.group(2) or 0))
            cur = None
    return out


def build(names: Iterable[str]) -> None:
    """Compile every library of ``names`` not built yet, all at once."""
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists() and _log_path(out).exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            _log_path(out).write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


#: streaming multiprocessors of an H100 (SXM): what the grid rules assume
#: when they are not told the card's count
H100_SMS = 132


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device``, for the grid rules."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets_cache = {}
_launch_counts = {}
#: the kernels that count their launches on the card, in the order of
#: launch_counts
COUNTED_ON_CARD = ("ell_gather_batched", "poisson_pairwise_batched", "kmc_event_loop_batched",
                   "banded_matvec_out", "wkb_fly_matvec_out", "transport_pack",
                   "transport_blocks", "transport_rows", "transport_refine",
                   "transport_rows_update", "heat_dense_substep", "heat_cg_begin",
                   "heat_cg_end", "while_cond", "stored_matvec", "transport_tail64",
                   "cg_matvec_dot", "poisson_exact_batched")


def launch_counts(device):
    """int64 [len(COUNTED_ON_CARD)] on ``device``: the launches of those
    kernels as they ran on the card (each launch's first thread adds one).
    Made at the first request, which must come outside a capture
    (``ops.graph.Graph`` makes it before it captures)."""
    import torch

    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _launch_counts.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch_counts: first made inside a CUDA graph capture")
        buf = _launch_counts[device] = torch.zeros(len(COUNTED_ON_CARD), dtype=torch.int64,
                                                   device=device)
    return buf


def launch_counter(device, name: str) -> int:
    """The device address of kernel ``name``'s counter in launch_counts."""
    return launch_counts(device).data_ptr() + 8 * COUNTED_ON_CARD.index(name)


def tickets(device, count: int):
    """``count`` int32 tickets, zero between calls (the block that draws a
    strip's last ticket sets it back), one buffer per device and stream: the
    kernels that use them run in stream order, so they share it."""
    import torch

    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets_cache.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets_cache[key] = buf
    return buf
