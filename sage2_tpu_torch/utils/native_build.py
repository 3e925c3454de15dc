"""Build shared libraries and programs from the checkout's sources into
the port's own build folder (``sage2_tpu_torch/_build``, listed in
.gitignore).

An output's file name carries a hash of its sources and of the full
compiler command, so a build is reused only when both are unchanged: a
``.so`` or program left over from other sources or other flags is never
loaded or run (the reference's wrappers reuse any build newer than its
source). No ``-march=native``: a build must run on any host of the same
kind.

Builds go to a private temporary name and are renamed into place, so a
concurrent process never loads a partly written file. Several libraries
are compiled at once, one compiler process each.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, NamedTuple, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


class LibSpec(NamedTuple):
    """One shared library, or with ``executable`` one program:
    ``command`` is the compiler and its flags; ``sources`` are compiled,
    ``depends`` (headers) only hashed; ``link`` (libraries, ``-lz``)
    follows the sources on the command line."""

    name: str
    command: Sequence[str]
    sources: Sequence[str]
    depends: Sequence[str] = ()
    link: Sequence[str] = ()
    executable: bool = False


class BuildError(RuntimeError):
    pass


def library_path(spec: LibSpec) -> str:
    h = hashlib.sha256()
    for path in list(spec.sources) + list(spec.depends):
        with open(path, "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    link = ["--", *spec.link] if spec.link else []
    h.update("\0".join(list(spec.command) + link).encode())
    tag = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{spec.name}-{tag}" if spec.executable
                        else f"lib{spec.name}-{tag}.so")


def build_all(specs: Sequence[LibSpec], timeout: float = 600.0) -> List[str]:
    """Paths of the builds, compiling the missing ones concurrently.

    Raises BuildError with the compiler's output when a build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [library_path(s) for s in specs]
    running = []
    for spec, out in zip(specs, paths):
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = (list(spec.command) + list(spec.sources) + list(spec.link)
               + ["-o", tmp])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((spec, out, tmp, cmd, proc))
    errors = []
    for spec, out, tmp, cmd, proc in running:
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"{spec.name}: timed out after {timeout} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{spec.name}: {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise BuildError("build failed:\n" + "\n".join(errors))
    return paths
