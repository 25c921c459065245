"""Build and bind the hand-written CUDA kernels in ``cerebro_tpu_torch/csrc``.

Each ``.cu`` file exports a plain C launch function. It is compiled with
``nvcc`` for ``sm_90a`` into ``cerebro_tpu_torch/_build/`` on first use (the
file name carries a hash of the source, so an edited source is rebuilt) and
loaded with ``ctypes``. Nothing is compiled or loaded at import time: this
module imports on machines without ``nvcc`` or a GPU, where the wrappers
only ever take their plain PyTorch versions.

A launch function runs on the caller's stream (``torch.cuda.current_stream``),
allocates nothing, and returns ``cudaGetLastError()``; ``Kernel.launch``
raises if that is not zero. Several ``Kernel`` handles may share one source
(and so one library), each with its own launch counts. A launch made while a
CUDA graph is captured under ``captured_launches`` only records the kernel
into the graph; whoever replays the graph adds the tally to
``Kernel.replayed`` (``replay_launches``), so ``Kernel.runs`` counts the
kernel's runs on the device, replays included. While the pipeline's
timer traces, each launch is a span ``kernel.<function>`` carrying its
integer arguments (the shapes) as ``shape``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Sequence

import torch

from cerebro_tpu_torch.utils import timing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Handles on one source build its library once, whichever asks first.
_BUILD_LOCK = threading.Lock()
# The tally of the graph capture running on this thread, if any.
_CAPTURE = threading.local()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class Kernel:
    """One CUDA source file and its C launch functions.

    ``functions`` maps each exported name to its ctypes argument types
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints).
    ``launches`` counts the launches made through ``launch`` (host calls);
    ``captured`` those of them recorded into a CUDA graph, which did not run
    then, and ``replayed`` the runs of recorded launches by replays. Callers
    that check which kernels a run went through reset and read them."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.launches = 0
        self.captured = 0
        self.replayed = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def runs(self) -> int:
        """The kernel's runs on the device: eager launches and replays."""
        return self.launches - self.captured + self.replayed

    def reset(self):
        self.launches = self.captured = self.replayed = 0

    @property
    def library(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def start_build(self):
        """Start ``nvcc`` for this source; returns (process, temp output), or
        None when the library is already built."""
        out = self.library
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def finish_build(self, started):
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, self.library)

    def build(self):
        with _BUILD_LOCK:
            self.finish_build(self.start_build())

    def _load(self):
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.library))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, name: str, *args):
        """Call launch function ``name`` with ``args`` followed by the current
        CUDA stream; raise if the launch reports an error."""
        fn = getattr(self._load(), name)
        stream = torch.cuda.current_stream().cuda_stream
        with timing.span("kernel." + name) as sp:
            if sp.id:
                types = self.functions[name]
                sp.set(shape=tuple(a for a, t in zip(args, types) if t is ctypes.c_int))
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.source.name}:{name} failed with CUDA error {err}"
            )
        self.launches += 1
        tally = getattr(_CAPTURE, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + 1
            self.captured += 1


@contextmanager
def captured_launches():
    """Around a CUDA graph's capture on this thread: yields a dict that
    fills with each kernel's launches recorded into the graph."""
    outer = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = {}
    try:
        yield _CAPTURE.tally
    finally:
        _CAPTURE.tally = outer


def replay_launches(tally: dict):
    """Count one replay of a graph whose capture gave ``tally``."""
    for k, n in tally.items():
        k.replayed += n


def build_all(kernels: Sequence[Kernel]) -> float:
    """Build every library the kernels need with one ``nvcc`` each, all
    running at once; a source that several kernels share is built once.
    Returns the wall seconds the builds took."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        started = {}
        for k in kernels:
            if k.library not in started:
                started[k.library] = (k, k.start_build())
        for k, s in started.values():
            k.finish_build(s)
    for k in kernels:
        k.build_log = started[k.library][0].build_log
    return time.perf_counter() - t0
