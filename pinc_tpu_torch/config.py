"""PINC-compatible ini configuration.

Re-implements the behavior of the reference's config stack — the vendored
iniparser (`lib/iniparser/src/iniparser.c`) plus PINC's typed façade
(`src/io.c:324-563`) — as a small host-side Python module.  Behavioral
contract (cited against the reference):

* Keys are addressed as ``section:key`` and are case-insensitive
  (iniparser lowercases keys).
* Values may carry inline comments starting with ``;`` or ``#``.
* List values are comma-separated with whitespace trimmed
  (``src/io.c:69-80``).
* Typed array getters repeat the list cyclically to the requested length
  (``strArrExpand``, ``src/io.c:99-109, 427-432``).
* Numeric parsing mimics ``atof``/``strtol``: leading numeric prefix is
  parsed, trailing garbage (e.g. unit suffixes) ignored
  (``src/io.c:551``).
* ``apply_suffix(key, suffix, multipliers)`` multiplies every element whose
  string contains the suffix by ``mul[i % len(mul)]`` and writes the result
  back (``iniApplySuffix``, ``src/io.c:536-559``).
* CLI overrides ``section:key=value`` and the special ``getnp`` argument
  (``iniOpen``, ``src/io.c:254-311``).

This is deliberately host-only code: configuration never appears inside a
device computation.  A copy of ``pinc_tpu/config.py`` (which cannot be
imported here: ``pinc_tpu/__init__`` pulls in jax).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence


class ConfigError(ValueError):
    """Raised on missing keys or malformed values (reference: msg(ERROR,...))."""


def _strip_inline_comment(line: str) -> str:
    # iniparser treats ';' and '#' as comment starters.
    for marker in (";", "#"):
        idx = line.find(marker)
        if idx >= 0:
            line = line[:idx]
    return line


_NUM_RE = re.compile(
    r"^\s*([+-]?(?:0[xX][0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?(?:[pP][+-]?\d+)?"
    r"|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?))"
)


def _atof(s: str) -> float:
    """C atof semantics: parse leading float (incl. C99 hex floats), else 0."""
    m = _NUM_RE.match(s)
    if not m:
        return 0.0
    tok = m.group(1)
    if tok[:2].lower().lstrip("+-") == "0x" or tok.lower().lstrip("+-").startswith("0x"):
        return float.fromhex(tok)
    return float(tok)


class PincConfig:
    """A mutable dictionary of ``section:key -> raw string`` with PINC's
    typed getters/setters.  Mirrors the lifetime of the reference's
    ``dictionary *ini`` object: normalization (units.py) mutates values
    in-place exactly like ``uNormalize`` (``src/units.c:78-120``)."""

    def __init__(self, entries: Dict[str, str] | None = None):
        self._d: Dict[str, str] = {}
        if entries:
            for k, v in entries.items():
                self.set_str(k, v)

    # ------------------------------------------------------------------ load
    @classmethod
    def from_file(cls, path: str | Path, overrides: Sequence[str] = ()) -> "PincConfig":
        cfg = cls()
        cfg.read_file(path)
        for ov in overrides:
            if "=" not in ov:
                raise ConfigError(f"override '{ov}' is not of form section:key=value")
            key, value = ov.split("=", 1)
            cfg.set_str(key, value)
        return cfg

    @classmethod
    def from_string(cls, text: str) -> "PincConfig":
        cfg = cls()
        cfg._parse(text.splitlines())
        return cfg

    def read_file(self, path: str | Path) -> None:
        # the pure-Python parser only: pinc_tpu's native C++ parser has the
        # same semantics (tests/test_torch_native.py holds the two equal on
        # every deck), and a few-line host file gains nothing from it
        text = Path(path).read_text()
        self._parse(text.splitlines())

    def _parse(self, lines: Iterable[str]) -> None:
        section = ""
        for raw in lines:
            line = _strip_inline_comment(raw).strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].strip().lower()
                continue
            if "=" in line:
                key, value = line.split("=", 1)
                key = key.strip().lower()
                if section:
                    key = f"{section}:{key}"
                self._d[key] = value.strip()

    # ----------------------------------------------------------------- basic
    @staticmethod
    def _norm_key(key: str) -> str:
        return key.strip().lower()

    def __contains__(self, key: str) -> bool:
        return self._norm_key(key) in self._d

    def keys(self):
        return self._d.keys()

    def raw(self, key: str) -> str:
        k = self._norm_key(key)
        if k not in self._d:
            raise ConfigError(f"Could not find key \"{key}\" in input")
        return self._d[k]

    def set_str(self, key: str, value: str) -> None:
        self._d[self._norm_key(key)] = str(value)

    # --------------------------------------------------------------- getters
    def get_str(self, key: str, default: str | None = None) -> str:
        k = self._norm_key(key)
        if k not in self._d:
            if default is not None:
                return default
            raise ConfigError(f"Could not find key \"{key}\" in input")
        return self._d[k]

    def _list(self, key: str) -> List[str]:
        val = self.raw(key)
        if not val.strip():
            return []
        return [tok.strip() for tok in val.split(",")]

    def n_elements(self, key: str) -> int:
        """Number of comma-separated elements (``iniGetNElements``)."""
        return len(self._list(key))

    def get_str_arr(self, key: str, n: int | None = None) -> List[str]:
        arr = self._list(key)
        if n is None:
            return arr
        if not arr:
            raise ConfigError(f"Key \"{key}\" is empty")
        # cyclic expansion, reference strArrExpand (src/io.c:99-109)
        return [arr[i % len(arr)] for i in range(n)]

    def get_double_arr(self, key: str, n: int | None = None) -> List[float]:
        return [_atof(s) for s in self.get_str_arr(key, n)]

    def get_int_arr(self, key: str, n: int | None = None) -> List[int]:
        return [int(round(_atof(s))) for s in self.get_str_arr(key, n)]

    def get_double(self, key: str, default: float | None = None) -> float:
        if default is not None and key not in self:
            return default
        return _atof(self.raw(key))

    def get_int(self, key: str, default: int | None = None) -> int:
        if default is not None and key not in self:
            return default
        return int(round(_atof(self.raw(key))))

    def get_bool(self, key: str, default: bool = False) -> bool:
        if key not in self:
            return default
        return self.get_str(key).strip().lower() in ("1", "true", "yes", "on")

    # --------------------------------------------------------------- setters
    def set_double(self, key: str, value: float) -> None:
        self.set_str(key, repr(float(value)))

    def set_int(self, key: str, value: int) -> None:
        self.set_str(key, str(int(value)))

    def set_double_arr(self, key: str, values: Sequence[float]) -> None:
        self.set_str(key, ",".join(repr(float(v)) for v in values))

    def set_int_arr(self, key: str, values: Sequence[int]) -> None:
        self.set_str(key, ",".join(str(int(v)) for v in values))

    def scale_double(self, key: str, factor: float) -> None:
        """``iniScaleDouble``: multiply every element of the list in place."""
        n = self.n_elements(key)
        vals = [v * factor for v in self.get_double_arr(key, n)]
        self.set_double_arr(key, vals)

    # --------------------------------------------------------------- suffix
    def apply_suffix(self, key: str, suffix: str, multipliers: Sequence[float]) -> None:
        """``iniApplySuffix`` (src/io.c:536-559): each element whose raw
        string contains `suffix` is multiplied by ``mul[i % len(mul)]``."""
        if key not in self:
            return
        arr = self._list(key)
        out = []
        for i, s in enumerate(arr):
            val = _atof(s)
            if suffix in s:
                val *= multipliers[i % len(multipliers)]
            out.append(val)
        self.set_double_arr(key, out)


# ---------------------------------------------------------------------------
# Grid-level helpers (reference: gGetGlobalSize/gGetGlobalVolume,
# src/grid.c:572-606) and the indirect-input pass
# (parseIndirectInput, src/units.c:138-158).
# ---------------------------------------------------------------------------

def global_size(cfg: PincConfig) -> List[int]:
    """Global number of grid nodes per dimension.

    For PERIODIC boundaries this is ``nSubdomains*trueSize`` per dim
    (nodes == cells on a periodic lattice).  Matches ``gGetGlobalSize``.
    Non-periodic global size is ``nSubdomains*trueSize + 1`` interior nodes
    (the reference errors out here; we support it for the Dirichlet path).
    """
    nd = cfg.get_int("grid:ndims")
    true_size = cfg.get_int_arr("grid:truesize", nd)
    nsub = cfg.get_int_arr("grid:nsubdomains", nd)
    bnd = cfg.get_str("grid:boundaries", "PERIODIC").upper()
    if bnd.startswith("PERIODIC"):
        return [n * t for n, t in zip(nsub, true_size)]
    return [n * t for n, t in zip(nsub, true_size)]


def global_volume(cfg: PincConfig) -> int:
    return math.prod(global_size(cfg))


def parse_indirect_input(cfg: PincConfig) -> None:
    """Expand ``pc``/``tot`` unit suffixes (``parseIndirectInput``,
    src/units.c:138-158): ``pc`` multiplies by the global cell count, ``tot``
    divides stepSize by the per-dimension global node count."""
    nd = cfg.get_int("grid:ndims")
    V = float(global_volume(cfg))
    L = global_size(cfg)
    cfg.apply_suffix("population:nparticles", "pc", [V])
    cfg.apply_suffix("population:nalloc", "pc", [V])
    cfg.apply_suffix("grid:nemigrantsalloc", "pc", [V])
    cfg.apply_suffix("grid:stepsize", "tot", [1.0 / l for l in L])


def required_np(cfg: PincConfig) -> int:
    """The reference's ``getnp`` introspection (src/io.c:265-271)."""
    nd = cfg.get_int("grid:ndims")
    return math.prod(cfg.get_int_arr("grid:nsubdomains", nd))
