"""YAML configuration system.

The scenario files use a small YAML subset -- nested block maps, block
lists of flow lists, flow lists, scalars (int, float, bool, quoted or bare
strings) and ``#`` comments -- which :func:`parse_yaml` reads without a
third-party YAML package.

Mirrors the semantics of the reference's ``GlobalConfig`` singleton
(reference: src/global_config.cpp:17-147, include/global_config.hpp:30-34):
the whole YAML file is flattened into a ``"lqr/N"``-style slash-keyed map,
optional keys get the same defaults as the reference, and the (typo'd)
reference key ``lqr/slove_type`` is accepted as-is so the four shipped
scenario YAMLs parse byte-for-byte.

Unlike the reference this is not a process-global singleton: ``GlobalConfig``
here is a plain object (create as many as you like), which is what a
batched sweep over *yaml params* needs.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside a quoted string."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the scenario files into nested dicts/lists.

    A key with no inline value opens a block: a map when the next
    meaningful line is more indented and holds ``key: value``, a list when
    it starts with ``- ``.
    """
    lines = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))

    def block(i: int, indent: int):
        if lines[i][1].startswith("- "):
            out = []
            while i < len(lines) and lines[i][0] == indent \
                    and lines[i][1].startswith("- "):
                out.append(_scalar(lines[i][1][2:]))
                i += 1
            return out, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, sep, rest = lines[i][1].partition(":")
            if not sep:
                raise ValueError(f"expected 'key: value': {lines[i][1]!r}")
            key = _scalar(key)
            i += 1
            if rest.strip():
                out[key] = _scalar(rest)
            elif i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("- "))):
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if not lines:
        return {}
    result, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[i][1]!r}")
    return result


# (key, path-in-yaml, type, default-or-None). Mirrors the hard-coded schema in
# reference src/global_config.cpp:22-92 (None default => required key).
_SCHEMA = [
    ("max_simulation_time", ("max_simulation_time",), float, None),
    ("delta_t", ("delta_t",), float, None),
    ("lqr/N", ("lqr", "N"), int, None),
    ("lqr/nx", ("lqr", "nx"), int, None),
    ("lqr/nu", ("lqr", "nu"), int, None),
    ("lqr/w_pos", ("lqr", "w_pos"), float, None),
    ("lqr/w_vel", ("lqr", "w_vel"), float, None),
    ("lqr/w_yaw", ("lqr", "w_yaw"), float, None),
    ("lqr/w_acc", ("lqr", "w_acc"), float, None),
    ("lqr/w_stl", ("lqr", "w_stl"), float, None),
    # the reference key is literally "slove_type" (src/global_config.cpp:33)
    ("lqr/slove_type", ("lqr", "slove_type"), str, None),
    ("lqr/alm_rho_init", ("lqr", "alm_rho_init"), float, 1.0),
    ("lqr/alm_gamma", ("lqr", "alm_gamma"), float, 0.0),
    ("lqr/max_rho", ("lqr", "max_rho"), float, 100.0),
    ("lqr/max_mu", ("lqr", "max_mu"), float, 1000.0),
    ("lqr/obstacle_exp_q1", ("lqr", "obstacle_exp_q1"), float, None),
    ("lqr/obstacle_exp_q2", ("lqr", "obstacle_exp_q2"), float, None),
    ("lqr/state_exp_q1", ("lqr", "state_exp_q1"), float, None),
    ("lqr/state_exp_q2", ("lqr", "state_exp_q2"), float, None),
    ("lqr/use_last_solution", ("lqr", "use_last_solution"), bool, None),
    ("iteration/max_iter", ("iteration", "max_iter"), int, None),
    ("iteration/init_lamb", ("iteration", "init_lamb"), float, None),
    ("iteration/lamb_decay", ("iteration", "lamb_decay"), float, None),
    ("iteration/lamb_amplify", ("iteration", "lamb_amplify"), float, None),
    ("iteration/max_lamb", ("iteration", "max_lamb"), float, None),
    ("iteration/convergence_threshold", ("iteration", "convergence_threshold"), float, None),
    ("iteration/accept_step_threshold", ("iteration", "accept_step_threshold"), float, None),
    # default mirrors src/global_config.cpp:54-55
    ("vehicle/reference_point", ("vehicle", "reference_point"), str, "gravity_center"),
    ("vehicle/target_velocity", ("vehicle", "target_velocity"), float, None),
    ("vehicle/wheelbase", ("vehicle", "wheelbase"), float, None),
    ("vehicle/width", ("vehicle", "width"), float, None),
    ("vehicle/length", ("vehicle", "length"), float, None),
    ("vehicle/velo_max", ("vehicle", "velo_max"), float, None),
    ("vehicle/velo_min", ("vehicle", "velo_min"), float, None),
    ("vehicle/yaw_lim", ("vehicle", "yaw_lim"), float, None),
    ("vehicle/acc_max", ("vehicle", "acc_max"), float, None),
    ("vehicle/acc_min", ("vehicle", "acc_min"), float, None),
    ("vehicle/stl_lim", ("vehicle", "stl_lim"), float, None),
    ("vehicle/d_safe", ("vehicle", "d_safe"), float, None),
    ("laneline/reference/x", ("laneline", "reference", "x"), list, None),
    ("laneline/reference/y", ("laneline", "reference", "y"), list, None),
    ("laneline/border", ("laneline", "border"), list, None),
    ("laneline/center_line", ("laneline", "center_line"), list, None),
    ("initial_condition", ("initial_condition",), list, None),
    # visualization defaults mirror src/global_config.cpp:79-92
    ("visualization/show_reference_line", ("visualization", "show_reference_line"), bool, False),
    ("visualization/show_obstacle_boundary", ("visualization", "show_obstacle_boundary"), bool, False),
]

_OPTIONAL_LIST_KEYS = [
    ("visualization/x_lim", ("visualization", "x_lim")),
    ("visualization/y_lim", ("visualization", "y_lim")),
]


def _dig(node: Any, path) -> Any:
    for p in path:
        if node is None or not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


class GlobalConfig:
    """Flat slash-keyed config map (reference: include/global_config.hpp:30-34)."""

    def __init__(self, config_map: Optional[Dict[str, Any]] = None):
        self.config_map: Dict[str, Any] = dict(config_map or {})

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "GlobalConfig":
        with open(path, "r") as f:
            raw = parse_yaml(f.read())
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "GlobalConfig":
        cfg: Dict[str, Any] = {}
        missing: List[str] = []
        for key, path, typ, default in _SCHEMA:
            val = _dig(raw, path)
            # accept the correctly-spelt alias too, on top of the reference's
            # literal "slove_type" key
            if val is None and key == "lqr/slove_type":
                val = _dig(raw, ("lqr", "solve_type"))
            if val is None:
                if default is None:
                    missing.append(key)
                    continue
                val = default
            if typ in (int, float, bool, str):
                val = typ(val)
            cfg[key] = val
        if missing:
            raise KeyError(f"missing required config keys: {missing}")
        for key, path in _OPTIONAL_LIST_KEYS:
            val = _dig(raw, path)
            if val is not None:
                cfg[key] = list(val)
        return cls(cfg)

    # -- access ------------------------------------------------------------
    def has_key(self, key: str) -> bool:
        return key in self.config_map

    def get(self, key: str, default: Any = None) -> Any:
        if key in self.config_map:
            return self.config_map[key]
        if default is not None:
            return default
        raise KeyError(f"configuration key not found: {key}")

    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    @property
    def solve_type(self) -> str:
        """"barrier" or "alm"; anything else falls back to "barrier" with the
        same forgiveness as reference src/cilqr_solver.cpp:34-41."""
        st = self.get("lqr/slove_type")
        return st if st in ("barrier", "alm") else "barrier"

    @property
    def num_obstacles(self) -> int:
        return len(self.get("initial_condition")) - 1
