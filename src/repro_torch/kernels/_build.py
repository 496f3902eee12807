"""Build the CUDA sources under csrc/ into shared libraries with a plain C
interface, loaded with ctypes.

`csrc/<name>.cu` becomes `build/repro_torch/<name>-<hash>.so` at the root
of the checkout (a git-ignored directory).  <hash> covers the source text,
the text of every header under csrc/ that it includes (`#include "..."`,
followed transitively), and the compiler flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  nvcc's resource report (`-Xptxas -v`: registers,
shared memory and spills of each kernel) is kept beside the library as
`<name>-<hash>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _source_text(name: str) -> bytes:
    """`csrc/<name>.cu` and the csrc/ headers it includes, each behind its
    file name, in the order first met."""
    seen, todo, parts = set(), [f"{name}.cu"], []
    while todo:
        file = todo.pop(0)
        if file in seen:
            continue
        seen.add(file)
        text = (CSRC / file).read_bytes()
        parts.append(file.encode() + b"\0" + text)
        todo += [inc.decode() for inc in _INCLUDE.findall(text)]
    return b"".join(parts)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source_text(name)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; return the
    library's path.  Raises with nvcc's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp.so"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
