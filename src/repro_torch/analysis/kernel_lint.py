"""Gopher Sentinel Pass 3, for torch: the CUDA-source kernel linter.

The JAX package's Pass 3 reads the Pallas kernels' Python ASTs. The port's
kernels are CUDA C++ (``kernels/csrc/*.cu``) called through ``ctypes``
wrappers (``kernels/*.py``), so this pass reads the CUDA sources with a
small tokenizer (no ``nvcc``: it runs anywhere) and the wrappers with
``ast``. Each JAX rule has its CUDA form:

- ``CUDA_GRID_DIVISIBILITY`` (``PALLAS_GRID_DIVISIBILITY``): every grid —
  ``kernel<<<grid, ...>>>``, ``dim3 grid(...)``, ``cfg.gridDim = ...`` and
  the grid of ``cudaLaunch*Kernel*`` — is a ceil-div ``(n + b - 1) / b``
  or a count of whole units (one block a row, ``B * KV``, a cluster
  count). A plain ``n / b`` drops the ragged tail. Names are resolved
  through their nearest earlier definition in the file; a grid that is a
  parameter of its launcher is reported as ``INFO`` (``GRID_UNRESOLVED``):
  its ``dim3`` is checked where it is built.
- ``CUDA_UNGUARDED_STORE`` (``PALLAS_UNMASKED_STORE``): a kernel that forms
  a global linear index from ``blockIdx`` and ``threadIdx`` must compare
  it (or an index derived from it: a grid-stride loop's variable) with a
  bound before its first global store through it — ``if (row >= rows)
  return;``, ``for (int i = gtid; i < n; i += stride)``.
- ``CUDA_MASK_MULTIPLY`` (``PALLAS_MASK_MULTIPLY``): a float value
  multiplied by a 0/1 flag (a ``bool``, a comparison, a load of a
  ``uint8_t``/``bool`` array) where a select is meant: an active ±inf
  value times a 0 flag is NaN. Integer (iota-like) products are exempt.
- ``PAD_LANE_UNCHECKED`` (warning; ``REDUCE_UNMASKED``): a gather through
  a lane read from an ELL ``nbr`` array that is not first tested against
  ``kPad`` (-1, or a sign test): left unchecked it reads ``x[-1]``.
- ``IO_ALIAS``: a wrapper passes one tensor as both an input
  (``const void*``) and an output (``void*``) of a launch whose kernels
  take ``__restrict__`` pointers.
- ``IDENTITY_MISMATCH``: an identity literal selected on a semiring
  (``SR == kMinPlus ? INFINITY : ...``, ``MINP ? INFINITY : -INFINITY``)
  that is not that semiring's ⊕ identity (``analysis.semiring.REGISTRY``).
- ``PARSE_ERROR``: an unterminated comment or string, or unbalanced
  brackets.

The rules are intraprocedural over kernels (``__global__``) and device
functions (``__device__``): a lane passed to a helper that tests it (K3's
``lane``) is the helper's to check. Nothing in a kernel is annotated away;
what the rules cannot prove is reported as ``INFO``.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import os
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.report import ERROR, INFO, WARNING, Violation

_OPS3 = ("<<<", ">>>", "<<=", ">>=", "...")
_OPS2 = ("->", "++", "--", "<<", ">>", "<=", ">=", "==", "!=", "&&", "||",
         "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "::")
_RELATIONAL = {"<", ">", "<=", ">="}
_ASSIGN = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>="}
_OPEN = {"(": ")", "[": "]", "{": "}"}
_TYPE_WORDS = {"void", "bool", "char", "short", "int", "long", "unsigned",
               "signed", "float", "double", "size_t", "int8_t", "uint8_t",
               "int16_t", "uint16_t", "int32_t", "uint32_t", "int64_t",
               "uint64_t", "half", "__half", "__nv_bfloat16", "auto",
               "int2", "int4", "float2", "float4", "dim3", "const",
               "volatile", "static", "constexpr", "__restrict__"}
_FLOAT_WORDS = {"float", "double", "half", "__half", "__nv_bfloat16"}
_FLAG_WORDS = {"bool", "uint8_t"}
_STORE_FNS = {"__stcg", "__stcs", "__stwt", "__stwb"}
_LOAD_FNS = {"__ldg", "__ldcg", "__ldca", "__ldcs", "__ldlu", "__ldcv"}
_IDENT_LITERALS = {"INFINITY": math.inf, "CUDART_INF_F": math.inf,
                   "HUGE_VALF": math.inf}
# the semiring a selector names (template flag or enum constant)
_SEMIRING_OF = {"kMinPlus": "min_plus", "kMaxFirst": "max_first",
                "kPlusTimes": "plus_times", "MINP": "min_plus"}
_PAD_NAMES = {"kPad", "PAD"}


class _ParseError(Exception):
    def __init__(self, line: int, msg: str):
        super().__init__(msg)
        self.line = line


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str          # 'id' | 'num' | 'op' | 'str'
    text: str
    line: int


def tokenize(src: str) -> List[_Tok]:
    """C/C++ tokens with their lines; comments, strings' contents and
    preprocessor lines dropped. Raises _ParseError on an unterminated
    comment, string or character literal."""
    out: List[_Tok] = []
    i, n, line = 0, len(src), 1
    bol = True                       # only whitespace since the line began
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            bol = True
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if c == "#" and bol:         # a directive, with its continuations
            while i < n and src[i] != "\n":
                if src[i] == "\\" and i + 1 < n and src[i + 1] == "\n":
                    line += 1
                    i += 1
                i += 1
            continue
        bol = False
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise _ParseError(line, "unterminated /* comment")
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                if src[j] == "\\":
                    j += 1
                elif src[j] == "\n":
                    raise _ParseError(line, f"unterminated {c} literal")
                j += 1
            if j >= n:
                raise _ParseError(line, f"unterminated {c} literal")
            out.append(_Tok("str", src[i:j + 1], line))
            i = j + 1
            continue
        m = re.match(r"[A-Za-z_]\w*", src[i:i + 256])
        if m:
            out.append(_Tok("id", m.group(0), line))
            i += len(m.group(0))
            continue
        m = re.match(r"(0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|"
                     r"\.\d+(?:[eE][+-]?\d+)?)[uUlLfF]*", src[i:i + 64])
        if m:
            out.append(_Tok("num", m.group(0), line))
            i += len(m.group(0))
            continue
        for op in _OPS3 + _OPS2:
            if src.startswith(op, i):
                out.append(_Tok("op", op, line))
                i += len(op)
                break
        else:
            out.append(_Tok("op", c, line))
            i += 1
    return out


def _brackets(toks: List[_Tok]) -> Dict[int, int]:
    """Open-bracket index -> its closing index (both ways), for (), [],
    {}. Raises _ParseError when they do not balance."""
    stack, match = [], {}
    for i, t in enumerate(toks):
        if t.kind != "op":
            continue
        if t.text in _OPEN:
            stack.append(i)
        elif t.text in (")", "]", "}"):
            if not stack or _OPEN[toks[stack[-1]].text] != t.text:
                raise _ParseError(t.line, f"unbalanced {t.text!r}")
            j = stack.pop()
            match[j] = i
            match[i] = j
    if stack:
        raise _ParseError(toks[stack[-1]].line,
                          f"unclosed {toks[stack[-1]].text!r}")
    return match


def _split_top(toks, lo: int, hi: int, match, sep: str = ","):
    """The [lo, hi) token range split at top-level ``sep`` tokens, as
    (start, end) ranges."""
    out, start, i = [], lo, lo
    while i < hi:
        t = toks[i]
        if t.kind == "op" and t.text in _OPEN and i in match:
            i = match[i] + 1
            continue
        if t.kind == "op" and t.text == sep:
            out.append((start, i))
            start = i + 1
        i += 1
    if start < hi or out:
        out.append((start, hi))
    return out


def _texts(toks, lo, hi) -> List[str]:
    return [t.text for t in toks[lo:hi]]


def _ids(toks, lo, hi) -> Set[str]:
    return {t.text for t in toks[lo:hi] if t.kind == "id"}


@dataclasses.dataclass
class _Param:
    name: str
    pointer: bool
    const: bool
    restrict: bool
    words: tuple


@dataclasses.dataclass
class _Func:
    name: str
    kind: str                       # 'global' | 'device' | 'host'
    params: List[_Param]
    body: tuple                     # (open, close) token indices
    line: int


def _params(toks, lo, hi, match) -> List[_Param]:
    out = []
    for a, b in _split_top(toks, lo, hi, match):
        words = [t.text for t in toks[a:b]]
        names = [t.text for t in toks[a:b] if t.kind == "id"]
        if not names or words == ["void"]:
            continue
        star = "*" in words
        const = star and "const" in words[:words.index("*")]
        out.append(_Param(names[-1], star, const, "__restrict__" in words,
                          tuple(words)))
    return out


def _functions(toks, match) -> List[_Func]:
    """Every function definition: its qualifier, name, params and body.
    A definition is ``name ( params ) [qualifiers] {`` at namespace
    level; ``__launch_bounds__(...)`` and template heads are skipped."""
    out = []
    depth_ns = set()                 # '{' of namespaces / extern blocks
    i = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        if t.kind == "op" and t.text == "{" and i in match:
            prev = toks[i - 1] if i else None
            # namespace { / namespace cg { / extern "C" {
            if prev is not None and (prev.text == "namespace"
                                     or prev.kind == "str"
                                     or (i >= 2 and toks[i - 2].text
                                         == "namespace")):
                depth_ns.add(i)
                i += 1
                continue
            i = match[i] + 1         # a struct/array body: skip
            continue
        if t.kind == "id" and i + 1 < n and toks[i + 1].text == "(" \
                and t.text != "__launch_bounds__" and (i + 1) in match:
            close = match[i + 1]
            j = close + 1
            while j < n and toks[j].kind == "id":   # const, noexcept ...
                j += 1
            if j < n and toks[j].text == "{" and j in match:
                # walk back over the declaration's head for a qualifier
                k, kind = i - 1, "host"
                while k >= 0 and not (toks[k].kind == "op" and toks[k].text
                                      in (";", "{", "}")):
                    if toks[k].text == "__global__":
                        kind = "global"
                    elif toks[k].text == "__device__" and kind == "host":
                        kind = "device"
                    k -= 1
                out.append(_Func(t.text, kind,
                                 _params(toks, i + 2, close, match),
                                 (j, match[j]), t.line))
                i = match[j] + 1
                continue
        i += 1
    return out


# ---------------------------------------------------------------- bodies

@dataclasses.dataclass
class _Def:
    name: str
    at: int                          # token index of the name
    expr: tuple                      # [lo, hi) of the defining expression
    pointer: bool
    words: tuple                     # the declaration's type words


def _stmt_start(toks, i, match) -> int:
    """The first token of the statement (or for-clause) holding ``i``."""
    k = i - 1
    while k >= 0:
        t = toks[k]
        if t.kind == "op" and t.text in (";", "{", "}"):
            return k + 1
        if t.kind == "op" and t.text == "(" and match.get(k, 0) > i:
            return k + 1
        if t.kind == "op" and t.text in (")", "]") and k in match:
            k = match[k] - 1
            continue
        k -= 1
    return 0


def _expr_end(toks, i, hi, match) -> int:
    """End (exclusive) of the expression starting at ``i``: the first
    top-level ``;`` or ``,`` or a ``)`` that closes an enclosing group."""
    while i < hi:
        t = toks[i]
        if t.kind == "op" and t.text in _OPEN and i in match:
            i = match[i] + 1
            continue
        if t.kind == "op" and t.text in (";", ",", ")", "]", "}"):
            return i
        i += 1
    return hi


def _defs(toks, lo, hi, match) -> List[_Def]:
    out = []
    for i in range(lo, hi - 1):
        t, nx = toks[i], toks[i + 1]
        if t.kind != "id" or nx.kind != "op" or nx.text not in _ASSIGN:
            continue
        if i > lo and toks[i - 1].text in (".", "->"):
            continue                 # a member store, not a variable
        s = _stmt_start(toks, i, match)
        head = [x.text for x in toks[s:i]]
        e = _expr_end(toks, i + 2, hi, match)
        out.append(_Def(t.text, i, (i + 2, e), "*" in head, tuple(head)))
    for i in range(lo, hi - 1):     # constructor-style: dim3 grid(a, b)
        t, nx = toks[i], toks[i + 1]
        if t.kind == "id" and nx.text == "(" and i > lo and \
                toks[i - 1].kind == "id" and toks[i - 1].text == "dim3":
            close = match.get(i + 1, i + 1)
            out.append(_Def(t.text, i, (i + 2, close), False, ("dim3",)))
    return out


def _operand_range(toks, i, lo, hi, match, left: bool) -> tuple:
    """The operand left or right of the binary operator at ``i``, up to
    the nearest top-level token of lower precedence."""
    stop = {",", ";", "?", ":", "&&", "||", "=", "{", "}", "!", "return",
            "(", ")", "[", "]"} | _ASSIGN
    if left:
        k = i - 1
        while k >= lo:
            t = toks[k]
            if t.text in (")", "]") and k in match:
                k = match[k] - 1
                continue
            if t.text in stop or t.text in _RELATIONAL or t.text in (
                    "==", "!="):
                break
            k -= 1
        return (k + 1, i)
    k = i + 1
    while k < hi:
        t = toks[k]
        if t.text in ("(", "[") and k in match:
            k = match[k] + 1
            continue
        if t.text in stop or t.text in _RELATIONAL or t.text in ("==", "!="):
            break
        k += 1
    return (i + 1, k)


class _Body:
    """One function body's tokens, definitions and comparisons."""

    def __init__(self, toks, fn: _Func, match, filename: str):
        self.toks, self.fn, self.match = toks, fn, match
        self.filename = filename
        self.lo, self.hi = fn.body[0] + 1, fn.body[1]
        self.defs = _defs(toks, self.lo, self.hi, match)
        self.params = {p.name: p for p in fn.params}
        self.shared = self._shared_names()
        self.types: Dict[str, tuple] = {}
        for d in self.defs:
            self.types.setdefault(d.name, d.words)
        self.comparisons = []        # (index, ids on both sides)
        for i in range(self.lo, self.hi):
            t = toks[i]
            if t.kind == "op" and t.text in _RELATIONAL | {"==", "!="}:
                a = _operand_range(toks, i, self.lo, self.hi, match, True)
                b = _operand_range(toks, i, self.lo, self.hi, match, False)
                self.comparisons.append((i, t.text, a, b,
                                         _ids(toks, *a) | _ids(toks, *b)))

    def _shared_names(self) -> Set[str]:
        out = set()
        for i in range(self.lo, self.hi):
            if self.toks[i].text != "__shared__":
                continue
            j = i + 1
            while j < self.hi and self.toks[j].text not in (";", "[", "="):
                j += 1
            if j > i + 1 and self.toks[j - 1].kind == "id":
                out.add(self.toks[j - 1].text)
        return out

    def where(self, i: int) -> str:
        return (f"{self.filename}:{self.toks[i].line} "
                f"(kernel {self.fn.name})")

    def deps(self, name: str) -> Set[str]:
        out = set()
        for d in self.defs:
            if d.name == name:
                out |= _ids(self.toks, *d.expr)
        return out

    def loads(self, d: _Def) -> bool:
        """Whether ``d``'s expression reads memory (a value, not an
        index computed from indices)."""
        ts = self.toks[d.expr[0]:d.expr[1]]
        return any(t.text == "[" or t.text in _LOAD_FNS for t in ts)

    def closure(self, seeds: Set[str], through_loads: bool = True
                ) -> Set[str]:
        """``seeds`` and every variable defined from them, transitively
        (only through index arithmetic unless ``through_loads``)."""
        got = set(seeds)
        changed = True
        while changed:
            changed = False
            for d in self.defs:
                if d.name not in got and _ids(self.toks, *d.expr) & got \
                        and (through_loads or not self.loads(d)):
                    got.add(d.name)
                    changed = True
        return got

    def ancestors(self, names: Set[str]) -> Set[str]:
        got = set(names)
        changed = True
        while changed:
            changed = False
            for n in list(got):
                new = self.deps(n) - got
                if new:
                    got |= new
                    changed = True
        return got

    def is_float(self, name: str, tpl: Set[str]) -> bool:
        words = set(self.types.get(name, ()))
        p = self.params.get(name)
        if p is not None:
            words = set(p.words)
        return bool(words & (_FLOAT_WORDS | tpl)) and "*" not in words

    def is_flag(self, name: str) -> bool:
        words = set(self.types.get(name, ()))
        p = self.params.get(name)
        if p is not None:
            words = set(p.words)
        return bool(words & _FLAG_WORDS) and "*" not in words

    def pointee(self, name: str) -> Set[str]:
        """The type words of the array a pointer name points to."""
        p = self.params.get(name)
        if p is not None and p.pointer:
            return set(p.words)
        return set(self.types.get(name, ())) if name in self.types else set()


# ---------------------------------------------------------------- rules

def _rule_unguarded_store(b: _Body, out: List[Violation]) -> None:
    toks = b.toks
    seeds = {d.name for d in b.defs
             if {"blockIdx", "threadIdx"} <= _ids(toks, *d.expr)}
    if not seeds:
        return
    index = b.closure(seeds, through_loads=False)
    globals_ = {p.name for p in b.fn.params
                if (p.pointer and not p.const)
                or (not p.pointer and not set(p.words) & _TYPE_WORDS - {
                    "const"})}
    globals_ = b.closure(globals_) - b.shared
    for i in range(b.lo, b.hi):
        t = toks[i]
        addr = None
        if t.kind == "id" and t.text in _STORE_FNS and toks[i + 1].text == "(":
            args = _split_top(toks, i + 2, b.match[i + 1], b.match)
            if args:
                addr = args[0]
                base = next((x.text for x in toks[addr[0]:addr[1]]
                             if x.kind == "id"), None)
                at = i
        elif t.text == "[" and i in b.match and b.match[i] + 1 < b.hi and \
                toks[b.match[i] + 1].text in _ASSIGN and toks[i - 1].kind == "id":
            addr = (i + 1, b.match[i])
            base = toks[i - 1].text
            k = i - 1
            while k - 2 >= b.lo and toks[k - 1].text in (".", "->"):
                k -= 2
            base = toks[k].text      # a.x_out[v] -> the struct param a
            at = i
        if addr is None or base not in globals_:
            continue
        used = (_ids(toks, *addr) | b.deps(base)) & index
        if not used:
            continue
        family = b.ancestors(used) & index
        if any(c[0] < at and c[1] in _RELATIONAL and c[4] & family
               for c in b.comparisons):
            continue
        out.append(Violation(
            pass_name="kernels", code="CUDA_UNGUARDED_STORE",
            where=b.where(at),
            detail=(f"a global store through `{base}` indexed by "
                    f"{sorted(used)}, which comes from blockIdx/threadIdx, "
                    "with no bound on that index before it: the threads "
                    "of the last block past the end write out of bounds. "
                    "Guard it first (`if (row >= rows) return;`, or a "
                    "grid-stride loop's `i < n`)"),
            severity=ERROR))
        return                      # the first unguarded store says it


def _primary(b: _Body, lo: int, hi: int) -> tuple:
    """(kind, name) of an operand range: ('id', x), ('load', ptr),
    ('cmp', None), ('cast', inner id) or ('other', None)."""
    toks = b.toks
    ts = toks[lo:hi]
    if not ts:
        return ("other", None)
    if len(ts) == 1 and ts[0].kind == "id":
        return ("id", ts[0].text)
    if ts[0].text == "(" and b.match.get(lo) == hi - 1:
        inner = toks[lo + 1:hi - 1]
        if any(x.text in _RELATIONAL | {"==", "!="} for x in inner):
            return ("cmp", None)
        return _primary(b, lo + 1, hi - 1)
    if ts[0].text == "(" and lo in b.match and b.match[lo] < hi - 1:
        # a cast: (float)x
        words = {x.text for x in toks[lo + 1:b.match[lo]]}
        if words <= _TYPE_WORDS | {"*"}:
            k, name = _primary(b, b.match[lo] + 1, hi)
            return ("cast", name) if k == "id" else (k, name)
    if ts[0].kind == "id" and len(ts) >= 3 and ts[1].text == "[" and \
            b.match.get(lo + 1) == hi - 1:
        return ("load", ts[0].text)
    if ts[0].kind == "id" and ts[0].text in _LOAD_FNS and len(ts) >= 3 \
            and b.match.get(lo + 1) == hi - 1:
        ptr = next((x.text for x in toks[lo + 2:hi - 1] if x.kind == "id"),
                   None)
        return ("load", ptr)
    return ("other", None)


def _rule_mask_multiply(b: _Body, tpl: Set[str],
                        out: List[Violation]) -> None:
    toks = b.toks
    for i in range(b.lo + 1, b.hi - 1):
        t = toks[i]
        if t.kind != "op" or t.text not in ("*", "*="):
            continue
        prev, nxt = toks[i - 1], toks[i + 1]
        if prev.kind == "id" and (
                prev.text in _TYPE_WORDS | tpl
                or (prev.text[:1].isupper() and nxt.kind == "id"
                    and toks[i + 2].text in ("=", ",", ")", ";", "["))):
            continue                 # a pointer declaration or cast
        if not (prev.kind in ("id", "num") or prev.text in (")", "]")):
            continue                 # a dereference
        sides = [_operand_range(toks, i, b.lo, b.hi, b.match, True),
                 _operand_range(toks, i, b.lo, b.hi, b.match, False)]
        kinds = [_primary(b, *s) for s in sides]

        def flag(k):
            kind, name = k
            if kind == "cmp":
                return True
            if kind in ("id", "cast") and name and b.is_flag(name):
                return True
            return kind == "load" and name and bool(
                b.pointee(name) & _FLAG_WORDS)

        def value(k):
            kind, name = k
            if kind in ("id", "cast") and name and b.is_float(name, tpl):
                return True
            return kind == "load" and name and bool(
                b.pointee(name) & (_FLOAT_WORDS | tpl))

        if (flag(kinds[0]) and value(kinds[1])) or \
                (flag(kinds[1]) and value(kinds[0])):
            lo, hi = sides[0][0], sides[1][1]
            out.append(Violation(
                pass_name="kernels", code="CUDA_MASK_MULTIPLY",
                where=b.where(i),
                detail=(f"`{' '.join(_texts(toks, lo, hi))}` multiplies a "
                        "value by a 0/1 flag: where the flag is 0 and the "
                        "value is ±inf (legal under min/max ⊕) the product "
                        "is NaN and poisons the reduction. Select instead: "
                        "`flag ? value : identity`"),
                severity=ERROR))


def _rule_pad_lane(b: _Body, out: List[Violation]) -> None:
    toks = b.toks
    sources = {p.name for p in b.fn.params if "nbr" in p.name}
    sources |= {d.name for d in b.defs if d.pointer and any(
        "nbr" in x for x in _ids(toks, *d.expr))}
    lanes = set()
    for d in b.defs:
        if d.pointer:
            continue
        ids = _ids(toks, *d.expr)
        if ids & sources or any(("nbr" in x) for x in ids
                                if x not in b.params or x in sources):
            if ids & _LOAD_FNS or any(toks[k].text == "[" for k in
                                      range(*d.expr)):
                lanes.add((d.name, d.at))
    for name, at in lanes:
        for i in range(at + 1, b.hi):
            t = toks[i]
            gather = None
            if t.kind == "id" and t.text in _LOAD_FNS and \
                    toks[i + 1].text == "(" and (i + 1) in b.match:
                ids = [x.text for x in toks[i + 2:b.match[i + 1]]
                       if x.kind == "id"]
                if name in ids and ids[0] != name and ids[0] not in sources:
                    gather = i
            elif t.text == "[" and i in b.match and toks[i - 1].kind == "id" \
                    and toks[i - 1].text not in sources | {name} and \
                    name in _ids(toks, i + 1, b.match[i]) and \
                    toks[b.match[i] + 1].text not in _ASSIGN:
                gather = i
            if gather is None:
                continue
            checked = any(
                at < c[0] < gather and name in c[4] and (
                    c[4] & _PAD_NAMES or "0" in _texts(toks, *c[2])
                    + _texts(toks, *c[3]) or "1" in _texts(toks, *c[3]))
                for c in b.comparisons)
            if not checked:
                out.append(Violation(
                    pass_name="kernels", code="PAD_LANE_UNCHECKED",
                    where=b.where(gather),
                    detail=(f"`{name}` is an ELL lane (read from an nbr "
                            "array, PAD = -1 in unused lanes) and is used "
                            "as a gather index with no test against kPad "
                            "before it: a PAD lane reads x[-1]. Test "
                            f"`if ({name} == kPad) continue;` first"),
                    severity=WARNING))
            break


def _literal(toks, lo, hi) -> Optional[float]:
    ts = [t.text for t in toks[lo:hi]]
    while ts and ts[0] == "(" and ts[-1] == ")":
        ts = ts[1:-1]
    neg = False
    if ts[:1] == ["-"]:
        neg, ts = True, ts[1:]
    if len(ts) != 1:
        return None
    x = ts[0]
    if x in _IDENT_LITERALS:
        v = _IDENT_LITERALS[x]
    elif re.fullmatch(r"\d+\.?\d*[fF]?|\.\d+[fF]?", x):
        v = float(x.rstrip("fF"))
    else:
        return None
    return -v if neg else v


def _rule_identity(toks, match, filename: str, fns, out) -> None:
    from repro_torch.analysis.semiring import REGISTRY
    ident = {k: s.plus_identity for k, s in REGISTRY.items()}
    for i, t in enumerate(toks):
        if t.text != "?":
            continue
        # the condition: `SR == kX`, `MINP`, `!MINP` right before '?'
        k = i - 1
        sel, negate = None, False
        if toks[k].kind == "id" and toks[k].text in _SEMIRING_OF:
            sel = toks[k].text
            if toks[k - 1].text == "!":
                negate = True
            elif toks[k - 1].text in ("==", "!=") and toks[k].text != "MINP":
                negate = toks[k - 1].text == "!="
        if sel is None:
            continue
        hi = _expr_end(toks, i + 1, len(toks), match)
        colon = None
        depth_q = 0
        j = i + 1
        while j < hi:
            x = toks[j]
            if x.text in _OPEN and j in match:
                j = match[j] + 1
                continue
            if x.text == "?":
                depth_q += 1
            elif x.text == ":":
                if depth_q == 0:
                    colon = j
                    break
                depth_q -= 1
            j += 1
        if colon is None:
            continue
        a = _literal(toks, i + 1, colon)
        if a is None:
            continue                 # not an identity select
        name = _SEMIRING_OF[sel]
        others = [n for n in ident if n != name]
        if sel == "MINP":
            others = ["max_first"]
        true_set, false_set = ([name], others) if not negate else (others,
                                                                  [name])
        end = _expr_end(toks, colon + 1, len(toks), match)
        bval = _literal(toks, colon + 1, end)
        for lits, sems, side in ((a, true_set, "true"),
                                 (bval, false_set, "false")):
            if lits is None or not sems:
                continue
            if not any(ident[s] == lits for s in sems):
                fn = next((f.name for f in fns
                           if f.body[0] < i < f.body[1]), "?")
                out.append(Violation(
                    pass_name="kernels", code="IDENTITY_MISMATCH",
                    where=f"{filename}:{t.line} (kernel {fn})",
                    detail=(f"the {side} branch of the select on `{sel}` "
                            f"gives {lits}, but the ⊕ identity of "
                            f"{' / '.join(sems)} is "
                            f"{' / '.join(str(ident[s]) for s in sems)}: "
                            "an empty row would not fold as identity"),
                    severity=ERROR))


def _grid_exprs(toks, match):
    """(token index, [dim ranges]) of every grid in the file."""
    out = []
    for i, t in enumerate(toks):
        if t.text == "<<<":
            end = next((j for j in range(i + 1, len(toks))
                        if toks[j].text == ">>>"), None)
            if end is None:
                raise _ParseError(t.line, "unclosed '<<<'")
            args = _split_top(toks, i + 1, end, match)
            out.append((i, [args[0]]))
        elif t.kind == "id" and t.text.startswith("grid") and \
                toks[i - 1].text == "dim3" and toks[i + 1].text == "(":
            out.append((i, _split_top(toks, i + 2, match[i + 1], match)))
        elif t.text == "gridDim" and toks[i - 1].text in (".", "->") and \
                toks[i + 1].text == "=":
            end = _expr_end(toks, i + 2, len(toks), match)
            out.append((i, [(i + 2, end)]))
        elif t.kind == "id" and t.text.startswith("cudaLaunch") and \
                "Kernel" in t.text and t.text != "cudaLaunchKernelEx" and \
                toks[i + 1].text == "(":
            args = _split_top(toks, i + 2, match[i + 1], match)
            if len(args) >= 2:
                out.append((i, [args[1]]))
    # a dim3(...) grid value: its own dims
    flat = []
    for i, dims in out:
        for lo, hi in dims:
            if hi - lo >= 3 and toks[lo].text == "dim3" and \
                    toks[lo + 1].text == "(":
                flat.append((i, _split_top(toks, lo + 2, match[lo + 1],
                                           match)))
            else:
                flat.append((i, [(lo, hi)]))
    return flat


def _strip_casts(ts: List[_Tok]) -> List[_Tok]:
    out, i = [], 0
    while i < len(ts):
        if ts[i].text == "(":
            j = i + 1
            while j < len(ts) and ts[j].text in _TYPE_WORDS:
                j += 1
            if j > i + 1 and j < len(ts) and ts[j].text == ")":
                i = j + 1
                continue
        out.append(ts[i])
        i += 1
    return out


def _divisions(ts: List[_Tok]):
    """(plain divisions as text, the token indices a ceil-div covers) of
    ``ts``: a division is fine as a ceil-div ``(n + b - 1) / b`` or an
    exact division of literals."""
    match = _brackets(ts)
    bad, covered = [], set()
    for i, t in enumerate(ts):
        if t.text != "/":
            continue
        if ts[i + 1].text == "(":
            dend = match[i + 1] + 1
        else:
            dend = i + 2
        div = [x.text for x in ts[i + 1:dend]]
        ok = False
        if ts[i - 1].text == ")":
            lo = match[i - 1]
            inner = [x.text for x in ts[lo + 1:i - 1]]
            for cand in (div, div[1:-1] if div[:1] == ["("] else None):
                if not cand:
                    continue
                tails = (["+"] + cand + ["-", "1"], ["+"] + cand + ["-", "1u"],
                         ["+", "("] + cand + ["-", "1", ")"])
                if any(inner[-len(x):] == x for x in tails):
                    ok = True
                    covered |= set(range(lo, dend))
        elif ts[i - 1].kind == "num" and len(div) == 1 and div[0].isdigit():
            ok = float(ts[i - 1].text.rstrip("uUlLfF")) % int(div[0]) == 0
        if not ok:
            bad.append(" ".join(x.text for x in ts[max(i - 3, 0):dend]))
    return bad, covered


def _grid_check(toks, defs_by_name, ts: List[_Tok], before: int,
                depth: int = 0):
    """(plain divisions, unresolved names) of the grid expression ``ts``:
    its own divisions, then those of the definitions of the names outside
    a ceil-div (the nearest definition before token ``before``). A
    ceil-div's block size may be any expression."""
    ts = _strip_casts(ts)
    bad, covered = _divisions(ts)
    unresolved: Set[str] = set()
    for k, t in enumerate(ts):
        if t.kind != "id" or k in covered or (k and ts[k - 1].text in (
                ".", "->")) or t.text in _TYPE_WORDS:
            continue
        cands = [d for d in defs_by_name.get(t.text, ()) if d.at < before]
        if cands and depth < 6:
            d = max(cands, key=lambda d: d.at)
            b2, u2 = _grid_check(toks, defs_by_name,
                                 list(toks[d.expr[0]:d.expr[1]]), d.at,
                                 depth + 1)
            bad += b2
            unresolved |= u2
        elif not cands and not t.text.startswith("k") and \
                not t.text[:1].isupper():
            unresolved.add(t.text)
    return bad, unresolved


def _rule_grids(toks, grids, filename: str, fns, defs_by_name,
                out) -> None:
    for at, dims in grids:
        fn = next((f.name for f in fns if f.body[0] < at < f.body[1]), "?")
        where = f"{filename}:{toks[at].line} (launcher {fn})"
        for lo, hi in dims:
            bad, unresolved = _grid_check(toks, defs_by_name,
                                          list(toks[lo:hi]), at)
            text = " ".join(_texts(toks, lo, hi))
            if bad:
                out.append(Violation(
                    pass_name="kernels", code="CUDA_GRID_DIVISIBILITY",
                    where=where,
                    detail=(f"grid dimension `{text}` divides without "
                            f"rounding up ({'; '.join(bad)}): the ragged "
                            "tail's rows get no block. Use the ceil-div "
                            "`(n + b - 1) / b`"),
                    severity=ERROR))
            elif unresolved:
                out.append(Violation(
                    pass_name="kernels", code="GRID_UNRESOLVED",
                    where=where,
                    detail=(f"grid dimension `{text}` comes from the "
                            f"launcher's parameters {sorted(unresolved)}: "
                            "a count of whole units as far as this file "
                            "shows (a dim3 grid is checked where it is "
                            "built)"),
                    severity=INFO))


# ---------------------------------------------------------------- entry

def _parse(src: str, filename: str):
    toks = tokenize(src)
    match = _brackets(toks)
    return toks, match


def launch_table(src: str, filename: str = "<string>") -> Dict[str, dict]:
    """The ``extern "C"`` launch functions of one CUDA source: name ->
    {'dirs': per parameter 'in' (const void*), 'out' (void*) or None,
    'restrict': whether a kernel it launches takes __restrict__
    pointers}. Raises _ParseError on a source that does not parse."""
    toks, match = _parse(src, filename)
    fns = _functions(toks, match)
    by_name: Dict[str, List[_Func]] = {}
    for f in fns:
        by_name.setdefault(f.name, []).append(f)
    restricted = {f.name for f in fns if f.kind == "global"
                  and any(p.restrict for p in f.params)}

    def reaches(f: _Func, seen: Set[str]) -> bool:
        ids = _ids(toks, *f.body)
        if ids & restricted:
            return True
        for name in ids - seen:
            for g in by_name.get(name, ()):
                if g.kind == "host" and reaches(g, seen | {name}):
                    return True
        return False

    out = {}
    for i, t in enumerate(toks):
        if t.kind == "str" and t.text == '"C"' and toks[i - 1].text == \
                "extern":
            f = next((f for f in fns if f.body[0] > i), None)
            if f is None:
                continue
            dirs = []
            for p in f.params:
                if p.pointer and "void" in p.words:
                    dirs.append("in" if p.const else "out")
                else:
                    dirs.append(None)
            out[f.name] = {"dirs": dirs, "restrict": reaches(f, {f.name})}
    return out


def lint_cuda_source(src: str, filename: str = "<string>") -> List[Violation]:
    """Pass 3 over one CUDA source: grid divisibility, guarded stores,
    mask multiplies, PAD lanes and identity literals."""
    try:
        toks, match = _parse(src, filename)
    except _ParseError as e:
        return [Violation(
            pass_name="kernels", code="PARSE_ERROR",
            where=f"{filename}:{e.line}", detail=f"cannot parse: {e}",
            severity=ERROR)]
    fns = _functions(toks, match)
    out: List[Violation] = []
    try:
        grids = _grid_exprs(toks, match)
    except _ParseError as e:
        return [Violation(
            pass_name="kernels", code="PARSE_ERROR",
            where=f"{filename}:{e.line}", detail=f"cannot parse: {e}",
            severity=ERROR)]
    all_defs = _defs(toks, 0, len(toks), match)
    defs_by_name: Dict[str, list] = {}
    for d in all_defs:
        defs_by_name.setdefault(d.name, []).append(d)
    tpl = {t.text for i, t in enumerate(toks) if t.kind == "id" and i > 0
           and toks[i - 1].text in ("typename", "class")
           and i > 1 and any(toks[k].text == "template"
                             for k in range(max(i - 8, 0), i))}
    for f in fns:
        if f.kind not in ("global", "device"):
            continue
        b = _Body(toks, f, match, filename)
        if f.kind == "global":
            _rule_unguarded_store(b, out)
        _rule_mask_multiply(b, tpl, out)
        _rule_pad_lane(b, out)
    _rule_identity(toks, match, filename, fns, out)
    _rule_grids(toks, grids, filename, fns, defs_by_name, out)
    return out


def lint_wrapper_source(src: str, filename: str = "<string>",
                        launches: Optional[Dict[str, dict]] = None
                        ) -> List[Violation]:
    """Pass 3 over one Python wrapper module: ``IO_ALIAS`` at each call of
    a launch function of ``launches`` (default: the repo's
    :func:`launch_table`s)."""
    if launches is None:
        launches = _repo_launches()
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Violation(
            pass_name="kernels", code="PARSE_ERROR",
            where=f"{filename}:{e.lineno or 0}",
            detail=f"cannot parse: {e.msg}", severity=ERROR)]
    out: List[Violation] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in launches):
                continue
            info = launches[call.func.attr]
            where = f"{filename}:{call.lineno} (wrapper {fn.name})"
            args = _spliced(call.args, fn)
            if args is None:
                if info["restrict"]:
                    out.append(Violation(
                        pass_name="kernels", code="IO_ALIAS", where=where,
                        detail=(f"{call.func.attr} takes a starred "
                                "argument this pass cannot expand: the "
                                "tensors' roles are not checked here"),
                        severity=INFO))
                continue
            roles: Dict[str, Set[str]] = {}
            for a, d in zip(args, info["dirs"]):
                if d is None:
                    continue
                if (isinstance(a, ast.Call)
                        and isinstance(a.func, ast.Attribute)
                        and a.func.attr == "data_ptr"):
                    roles.setdefault(ast.unparse(a.func.value),
                                     set()).add(d)
            both = sorted(k for k, r in roles.items() if r == {"in", "out"})
            if both and info["restrict"]:
                out.append(Violation(
                    pass_name="kernels", code="IO_ALIAS", where=where,
                    detail=(f"{both} passed to {call.func.attr} as both an "
                            "input and an output, and its kernel's "
                            "pointers are __restrict__: the compiler may "
                            "read the input after the output was written. "
                            "Pass a separate output tensor"),
                    severity=ERROR))
    return out


def _spliced(args, fn: ast.FunctionDef):
    """``args`` with each ``*name`` replaced by the elements of the tuple
    or list literal ``name`` was last assigned in ``fn``; None when a
    starred argument is anything else."""
    lits = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            lits[node.targets[0].id] = node.value.elts
    out = []
    for a in args:
        if not isinstance(a, ast.Starred):
            out.append(a)
        elif isinstance(a.value, ast.Name) and a.value.id in lits:
            out.extend(lits[a.value.id])
        else:
            return None
    return out


def _csrc() -> str:
    import repro_torch.kernels as _k
    return os.path.join(os.path.dirname(_k.__file__), "csrc")


def _repo_launches() -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    base = _csrc()
    for name in sorted(os.listdir(base)):
        if name.endswith(".cu"):
            with open(os.path.join(base, name)) as f:
                try:
                    out.update(launch_table(f.read(), name))
                except _ParseError:
                    pass             # lint_cuda_source reports it
    return out


def lint_source(src: str, filename: str = "<string>") -> List[Violation]:
    """Pass 3 over one source: a ``.py`` wrapper or a CUDA source."""
    if filename.endswith(".py"):
        return lint_wrapper_source(src, filename)
    return lint_cuda_source(src, filename)


def lint_kernel_file(path: str) -> List[Violation]:
    with open(path, "r") as f:
        return lint_source(f.read(), filename=os.path.basename(path))


def lint_kernels(paths: Optional[List[str]] = None) -> List[Violation]:
    """Pass 3 over the repo's CUDA sources (``kernels/csrc/*.cu``) and
    their wrappers (``kernels/*.py``)."""
    if paths is None:
        base = _csrc()
        paths = sorted(os.path.join(base, n) for n in os.listdir(base)
                       if n.endswith(".cu"))
        wrappers = os.path.dirname(base)
        paths += sorted(os.path.join(wrappers, n)
                        for n in os.listdir(wrappers) if n.endswith(".py"))
    out: List[Violation] = []
    for p in paths:
        out.extend(lint_kernel_file(p))
    return out
