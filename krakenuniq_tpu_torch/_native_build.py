"""Build and load the port's native host module, `kuniq_native_torch`.

The source is `native/kuniq_native.cpp` (the parser, the packed-input
encoder, the kraken-line formatters and the CHD placement of the span
route). It is compiled at first use, never at import, by the C++ compiler
directly: `-O3 -std=c++17 -shared -fPIC` against CPython's and numpy's
headers, into `_build/`, named by a hash of the source, the flags and the
interpreter, so an edited source rebuilds and an unchanged one is reused.
Several processes may build at once (test workers, a script and its
children): one `fcntl.flock` on `_build/native.lock` lets one compile while
the others wait, and the library is written under a temporary name and
renamed into place. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import shlex
import shutil
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "kuniq_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
MODULE = "kuniq_native_torch"
CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_module = None  # the loaded extension (process-wide: a library loads once)


def _compiler() -> list[str]:
    """$CXX, else the c++ or g++ on PATH, else the interpreter's own."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    return shlex.split(cxx or sysconfig.get_config_var("CXX") or "c++")


def _includes() -> list[str]:
    return ["-I", sysconfig.get_paths()["include"], "-I", np.get_include()]


def so_path() -> str:
    """Where the library for this source, these flags and this
    interpreter lives (built or not)."""
    with open(SOURCE, "rb") as f:
        key = f.read()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key += " ".join((*CXXFLAGS, *_includes(), suffix)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{MODULE}_{digest}{suffix}")


def build() -> str:
    """Compile the module unless it is built; returns the library's path.
    Raises RuntimeError with the compiler's output if the build fails."""
    path = so_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it while we waited
            return path
        include = sysconfig.get_paths()["include"]
        if not os.path.exists(os.path.join(include, "Python.h")):
            raise RuntimeError(f"cannot build {MODULE}: no Python.h under {include}")
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [*_compiler(), *CXXFLAGS, *_includes(), SOURCE, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {MODULE}: {cmd[0]}: {e}") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"building {MODULE} failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, path)
    return path


def native():
    """The loaded `kuniq_native_torch` module, built on first use."""
    global _module
    if _module is None:
        path = build()
        spec = importlib.util.spec_from_file_location(MODULE, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    return _module
