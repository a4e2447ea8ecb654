"""Build variants of one kernel source and stand them in for the shipped
kernels, for the layout tools (``k5_layouts.py``, ``k8_layouts.py``).

A variant is a source built with ``-D`` defines into a library of its own
under ``build/<subdir>/``, every variant in parallel, with ``-Xptxas -v``.
:func:`use` replaces the named launch functions in the loaded kernel
library with a variant's, so the wrappers launch its kernels until
``use(None)``.
"""
import ctypes
import re
import subprocess
from pathlib import Path


class Variant:
    """A library built from ``source`` with ``defines``: its launch
    functions by name, ptxas' ``-v`` report and, where asked, its SASS."""

    def __init__(self, tag, source, defines):
        self.tag, self.source, self.defines = tag, Path(source), defines
        self.launch, self.lib = {}, None
        self.ptxas = self.sass = ""


def parse_layout(tool: str, layout: str, first: str, second: str,
                 keys: dict) -> dict:
    """``AxB`` with optional ``<letter><int>`` suffixes -> the defines
    ``{first: A, second: B, keys[letter]: int, ...}``."""
    suffix = rf"((?:[{''.join(keys)}]\d+)*)" if keys else "()"
    m = re.fullmatch(rf"(\d+)x(\d+){suffix}", layout)
    if not m:
        raise SystemExit(f"{tool}: bad layout {layout!r}")
    out = {first: int(m[1]), second: int(m[2])}
    for key, val in re.findall(r"([a-z])(\d+)", m[3]):
        out[keys[key]] = int(val)
    return out


def build(variants, subdir: str, launches, sass: bool = False) -> None:
    """Build every variant's library in parallel (``nvcc -Xptxas -v``) and
    load its ``launches``, typed as the shipped library's; with ``sass``,
    disassemble it (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    out = _build.BUILD_ROOT / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for v in variants:
        so = out / f"{v.source.stem}_{v.tag}.so"
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-Xptxas", "-v",
               *(f"-D{k}={val}" for k, val in v.defines.items()), "-shared",
               str(v.source), "-o", str(so)]
        procs.append((v, so, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    shipped = _build.library()
    for v, so, cmd, p in procs:
        v.ptxas, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\n{v.ptxas}")
        v.lib = ctypes.CDLL(str(so))
        for name in launches:
            fn = getattr(v.lib, name)
            fn.argtypes = getattr(shipped, name).argtypes
            fn.restype = getattr(shipped, name).restype
            v.launch[name] = fn
        if sass:
            v.sass = subprocess.run(
                [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
                capture_output=True, text=True, check=True).stdout


def ptxas_report(text: str) -> dict:
    """Each function's registers and stack and spill bytes in ptxas' ``-v``
    report, by mangled name."""
    cur, rep = None, {}
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = rep.setdefault(m[1], {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    return rep


class Swapped:
    """The loaded kernel library with some launch functions replaced."""

    def __init__(self, lib, launch):
        self._lib = lib
        for name, fn in launch.items():
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def use(variant) -> None:
    """Let the wrappers launch ``variant``'s kernels (None: the shipped
    ones)."""
    from repro_torch.kernels import _build
    lib = _build.library()
    lib = lib._lib if isinstance(lib, Swapped) else lib
    _build._lib = lib if variant is None else Swapped(lib, variant.launch)


def smi(query: str) -> str:
    """The card's ``nvidia-smi --query-gpu=<query>`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() \
        .splitlines()[0]
