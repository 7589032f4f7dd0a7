"""Reference lines and routing lines.

Parity targets:
- ``ReferenceLine``: densely-sampled laterally-offset lane line built on the
  arc-length spline (reference src/utils.cpp:21-35, 60-67). The offset is
  applied perpendicular to the local yaw:  lx = x - w*sin(yaw),
  ly = y + w*cos(yaw).
- ``RoutingLine``: a time-indexed (x, y, yaw) trajectory for agents with
  slicing (reference src/utils.cpp:37-58, include/utils.hpp:53-68).

Design: both are host-side constructions (static per scenario)
that export padded, stacked device arrays; all *device* consumers (nearest
point projection, obstacle windows) operate on those arrays.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ilqr_tpu.utils.splines import CubicSpline2D

# Coordinate used for padding device arrays: far enough that padded entries
# never win a nearest-point argmin and never activate obstacle constraints,
# while (coord**2)**2 stays finite in float32.
PAD_COORD = 1.0e6


class ReferenceLine:
    """Dense offset lane line sampled every ``accuracy`` metres."""

    def __init__(self, x: Sequence[float], y: Sequence[float], width: float = 0.0,
                 accuracy: float = 0.1):
        self.delta_s = float(accuracy)
        self.delta_d = float(width)
        self.spline = CubicSpline2D(x, y)
        xs: List[float] = []
        ys: List[float] = []
        yaws: List[float] = []
        ss: List[float] = []
        # accumulate s exactly like the reference loop (src/utils.cpp:25):
        # float64 accumulation, endpoint inclusive, so the sample count (and
        # thus nearest-point candidates) matches.
        s = 0.0
        s_end = float(self.spline.s[-1])
        while s <= s_end:
            px, py = self.spline.calc_position(s)
            lyaw = float(self.spline.calc_yaw(s))
            xs.append(float(px) - width * np.sin(lyaw))
            ys.append(float(py) + width * np.cos(lyaw))
            yaws.append(lyaw)
            ss.append(s)
            s += self.delta_s
        self.x = np.asarray(xs)
        self.y = np.asarray(ys)
        self.yaw = np.asarray(yaws)
        self.longitude = np.asarray(ss)

    def __len__(self) -> int:
        return len(self.x)

    @property
    def size(self) -> int:
        return len(self.x)

    @property
    def length(self) -> float:
        return float(self.spline.s[-1])

    def calc_position(self, cur_s: float) -> np.ndarray:
        """(x, y, yaw) of the offset line at arc length ``cur_s``
        (reference src/utils.cpp:60-67)."""
        px, py = self.spline.calc_position(cur_s)
        lyaw = self.spline.calc_yaw(cur_s)
        lx = px - self.delta_d * np.sin(lyaw)
        ly = py + self.delta_d * np.cos(lyaw)
        return np.stack([lx, ly, lyaw], axis=-1)

    def as_array(self, pad_to: int | None = None, dtype=np.float64) -> np.ndarray:
        """(P, 4) array of [x, y, yaw, s]; padded rows use PAD_COORD."""
        arr = np.stack([self.x, self.y, self.yaw, self.longitude], axis=-1).astype(dtype)
        if pad_to is not None and pad_to > arr.shape[0]:
            pad = np.zeros((pad_to - arr.shape[0], 4), dtype=dtype)
            pad[:, 0] = PAD_COORD
            pad[:, 1] = PAD_COORD
            arr = np.concatenate([arr, pad], axis=0)
        return arr


class RoutingLine:
    """Time-indexed (x, y, yaw) agent trajectory."""

    def __init__(self, x=None, y=None, yaw=None):
        self.x = list(x) if x is not None else []
        self.y = list(y) if y is not None else []
        self.yaw = list(yaw) if yaw is not None else []

    def __len__(self) -> int:
        return min(len(self.x), len(self.y), len(self.yaw))

    def __getitem__(self, index: int) -> np.ndarray:
        if index >= len(self):
            raise IndexError("RoutingLine index out of range")
        return np.array([self.x[index], self.y[index], self.yaw[index]])

    def subset(self, start: int, length: int) -> "RoutingLine":
        size = len(self)
        if start >= size or start + length > size or length <= 0:
            raise IndexError("RoutingLine.subset args out of range")
        return RoutingLine(
            self.x[start:start + length],
            self.y[start:start + length],
            self.yaw[start:start + length],
        )

    def as_array(self, dtype=np.float64) -> np.ndarray:
        """(T, 3) array of [x, y, yaw]."""
        return np.stack(
            [np.asarray(self.x), np.asarray(self.y), np.asarray(self.yaw)], axis=-1
        ).astype(dtype)


def stack_routing_lines(lines: Sequence[RoutingLine], dtype=np.float64) -> np.ndarray:
    """(M, T, 3) stacked agent trajectories, truncated to the common length."""
    if not lines:
        return np.zeros((0, 0, 3), dtype=dtype)
    t = min(len(l) for l in lines)
    return np.stack([l.as_array(dtype)[:t] for l in lines], axis=0)


def get_cur_obstacle_states(routing_lines: Sequence[RoutingLine],
                            time_index: int,
                            dtype=np.float64) -> np.ndarray:
    """(M, 3) obstacle states at ``time_index``.

    Reference src/utils.cpp:105-115: the first routing line is the ego's,
    so obstacles are ``routing_lines[1:]`` sampled at the tick (the C++
    returns columns of a 3xM matrix; we return rows of an (M, 3) array).
    """
    obstacles = routing_lines[1:]
    if not obstacles:
        return np.zeros((0, 3), dtype=dtype)
    return np.stack([np.asarray(rl[time_index], dtype=dtype)
                     for rl in obstacles], axis=0)
