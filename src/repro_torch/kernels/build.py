"""Build and load the hand-written CUDA kernels.

Each library is compiled by ``nvcc`` from its sources under ``csrc/`` into
a shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds to a minute).  Every source
of every library is compiled at once, one ``nvcc`` each, then each
library's objects are linked.  Libraries go to ``kernels/_build/`` (listed
in ``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is
built at import: the first call that needs a library builds it, except
in a rank of a multi-process run, which raises instead: the process that
starts the ranks builds first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# library name -> its sources; headers in csrc/ go into every hash.  The
# fused kernel's pass-1 instantiations are spread over six sources so that
# they compile in parallel.
SOURCES = {
    "zmc_fused_mc": ("fused_mc.cu", "fused_mc_compact.cu", "fused_mc_adapted.cu",
                     "fused_mc_sobol.cu", "fused_mc_sobol_compact.cu",
                     "fused_mc_sobol_adapted.cu"),
    "zmc_moments": ("moments.cu",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_LOADED: dict[str, ctypes.CDLL] = {}

# Hopper's per-SM limits for resident blocks (CUDA C++ Programming Guide,
# compute capability 9.0): 65536 registers, allocated per warp in units of
# 256 (8 a thread), and 2048 threads.
SM_REGISTERS, SM_THREADS, REG_UNIT = 65536, 2048, 8
PASS1_THREADS = 256


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built on this host")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / src for src in SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, *, verbose: bool = False) -> dict[str, dict]:
    """Compile the named libraries (default: all): one ``nvcc -c`` per
    source, all started together, then one link per library.  Returns
    ``{name: {"path", "seconds", "log"}}``; ``log`` holds ``-Xptxas -v``
    output (registers, spills) when ``verbose``.  Raises ``RuntimeError``
    with the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, out = {}, {}
    t0 = time.perf_counter()
    nvcc = None
    for name in names:
        path = _lib_path(name)
        if path.exists() and not verbose:
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or find_nvcc()
        objs = []
        for src in SOURCES[name]:
            obj = path.with_suffix(f".{Path(src).stem}.{os.getpid()}.o")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", str(obj), str(CSRC / src)]
            objs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        jobs[name] = (path, objs)
    for name, (path, objs) in jobs.items():
        logs = []
        for src, obj, proc in objs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} "
                                   f"(exit {proc.returncode}):\n{log}")
            logs.append(log)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in objs)],
                              capture_output=True, text=True)
        for _, obj, _ in objs:
            obj.unlink(missing_ok=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {name} failed (exit {link.returncode}):"
                               f"\n{link.stdout}{link.stderr}")
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": "".join(logs)}
    return out


def pass1_resources(log: str) -> list[dict]:
    """Per pass-1 instantiation in a ``-Xptxas -v`` log: its template
    arguments ``<stages, sobol, swept>``, registers, spill stores (bytes)
    and resident blocks per SM of 256 threads as its registers allow them
    (shared memory, under 10 KB a block at every launch shape of the
    port, does not limit it), in the log's order."""
    out, cur = [], None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"fused_mc_pass1ILi(\d)ELb(\d)ELb(\d)EE", line)
            cur = None
            if m:
                st, sob, sw = m.groups()
                cur = {"name": f"<{st},{'true' if sob == '1' else 'false'},"
                               f"{'true' if sw == '1' else 'false'}>",
                       "registers": None, "spill_stores": 0, "blocks_per_sm": None}
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif cur is not None and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            per_block = -(-regs // REG_UNIT) * REG_UNIT * PASS1_THREADS
            cur["registers"] = regs
            cur["blocks_per_sm"] = min(SM_REGISTERS // per_block,
                                       SM_THREADS // PASS1_THREADS)
            cur = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every
    exported function's ``argtypes``/``restype`` declared."""
    if name not in _LOADED:
        path = _lib_path(name)
        if not path.exists():
            if _in_group_of_ranks():
                raise RuntimeError(
                    f"{path.name} is not built: build the kernels "
                    "(repro_torch.kernels.build.build()) before starting "
                    "ranks; ranks never build them")
            build([name])
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _LOADED[name] = lib
    return _LOADED[name]


def _in_group_of_ranks() -> bool:
    """Whether this process is one rank of several (every rank would
    otherwise start its own nvcc builds of the same files)."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _declare(lib: ctypes.CDLL) -> None:
    """Declare ``argtypes``/``restype`` of each exported function the
    library has (each source exports its own)."""
    u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    i64 = ctypes.c_longlong
    signatures = {
        "zmc_chunk_samples": [],
        "zmc_fused_mc": [u32, u32, u32, u32,     # k0 k1 offset n_valid
                         u32, i32, ptr,          # round_stride n_rounds round_base
                         ptr, ptr, i32,          # fn_ids block_meta n_sweep
                         i32, ptr,               # has_stages sobol_dirs
                         ptr, i32,               # packed n_cols
                         ptr, ptr, i32,          # lo hi dim
                         i32, i32,               # n_fn_pad n_chunks
                         ptr, ptr, ptr],         # scratch out stream
        "zmc_random_bits": [u32, u32, ptr, ptr, ptr, i64, ptr],
        "zmc_sobol": [ptr, i32, u32, u32, ptr, ptr, ptr, ptr, i64, ptr],
        "zmc_sobol_walk": [ptr, i32, u32, i64, ptr, ptr],  # v dim start n pt stream
        "zmc_moments_cblk": [],
        "zmc_stratum_moments": [ptr, i32, i32, ptr, ptr],  # values rows cols out stream
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
