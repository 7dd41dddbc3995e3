"""Network topologies for bittide systems (numpy; the same builders as
``repro.core.topology``, kept here so the port never imports the JAX
package).

A topology is a directed multigraph stored as flat edge arrays (src, dst).
bittide links are physically bidirectional, so every builder emits both
directions of each link; the two directions are distinct edges (each end has
its own elastic buffer, §1.2 of the paper).

All builders used in the paper's experiments are provided (fully connected,
hourglass, cube — §5.3–§5.5), plus the 3-D torus used for the scale
simulation (Fig 18), and a few generic families used by the property tests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

__all__ = [
    "Topology",
    "fully_connected",
    "hourglass",
    "cube",
    "ring",
    "line",
    "star",
    "torus3d",
    "mesh2d",
    "random_regular",
    "from_links",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Directed graph as edge arrays.

    Attributes:
      num_nodes: N.
      src: (E,) int32 — sending node of each directed edge ``src -> dst``.
      dst: (E,) int32 — receiving node (owner of the elastic buffer).
      name: human-readable label for telemetry and plots.
    """

    num_nodes: int
    src: np.ndarray
    dst: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst must have identical shapes")
        if self.num_edges and (self.src.max() >= self.num_nodes or self.dst.max() >= self.num_nodes):
            raise ValueError("edge endpoint out of range")
        if np.any(self.src == self.dst):
            raise ValueError("self-loops are not valid bittide links")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_nodes).astype(np.int32)

    def reverse_edge_index(self) -> np.ndarray:
        """Index r with (src[r[e]], dst[r[e]]) == (dst[e], src[e]).

        Needed for round-trip logical latency (Table 1/2): RTT over a link is
        the sum of the logical latencies of its two directed edges.
        """
        lookup = {}
        for e in range(self.num_edges):
            lookup[(int(self.src[e]), int(self.dst[e]))] = e
        rev = np.empty(self.num_edges, np.int32)
        for e in range(self.num_edges):
            key = (int(self.dst[e]), int(self.src[e]))
            if key not in lookup:
                raise ValueError(f"edge {e} has no reverse edge; topology not bidirectional")
            rev[e] = lookup[key]
        return rev

    def is_connected(self) -> bool:
        adj = [[] for _ in range(self.num_nodes)]
        for s, d in zip(self.src, self.dst):
            adj[int(s)].append(int(d))
        seen = {0}
        stack = [0]
        while stack:
            for nbr in adj[stack.pop()]:
                if nbr not in seen:
                    seen.add(nbr)
                    stack.append(nbr)
        return len(seen) == self.num_nodes


def from_links(num_nodes: int, links: Iterable[Tuple[int, int]], name: str = "custom") -> Topology:
    """Build from undirected links; emits both directions per link."""
    src, dst = [], []
    for a, b in links:
        src += [a, b]
        dst += [b, a]
    return Topology(num_nodes, np.array(src), np.array(dst), name=name)


def fully_connected(n: int = 8) -> Topology:
    """Every node connected to every other node (paper §5.3, 8 nodes)."""
    links = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return from_links(n, links, name=f"fully_connected_{n}")


def hourglass(half: int = 4) -> Topology:
    """Two fully connected subgraphs joined by a single link (paper §5.4).

    Nodes [0, half) form one clique, [half, 2*half) the other; the bridge is
    the single link (half-1, half) — in the paper's figure the two groups of
    four are bridged by one cable.
    """
    links = [(i, j) for i in range(half) for j in range(i + 1, half)]
    links += [(half + i, half + j) for i in range(half) for j in range(i + 1, half)]
    links += [(half - 1, half)]
    return from_links(2 * half, links, name=f"hourglass_{2*half}")


def cube() -> Topology:
    """8 nodes on the corners of a cube, links along edges (paper §5.5)."""
    links = []
    for v in range(8):
        for bit in range(3):
            w = v ^ (1 << bit)
            if v < w:
                links.append((v, w))
    return from_links(8, links, name="cube")


def ring(n: int) -> Topology:
    links = [(i, (i + 1) % n) for i in range(n)]
    return from_links(n, links, name=f"ring_{n}")


def line(n: int) -> Topology:
    links = [(i, i + 1) for i in range(n - 1)]
    return from_links(n, links, name=f"line_{n}")


def star(n: int) -> Topology:
    links = [(0, i) for i in range(1, n)]
    return from_links(n, links, name=f"star_{n}")


def torus3d(k: int = 22) -> Topology:
    """k^3 nodes in a 3-D torus (paper Fig 18 uses k=22 -> 10648 nodes)."""
    def nid(x, y, z):
        return (x * k + y) * k + z

    links = []
    for x in range(k):
        for y in range(k):
            for z in range(k):
                links.append((nid(x, y, z), nid((x + 1) % k, y, z)))
                links.append((nid(x, y, z), nid(x, (y + 1) % k, z)))
                links.append((nid(x, y, z), nid(x, y, (z + 1) % k)))
    return from_links(k ** 3, links, name=f"torus3d_{k}")


def mesh2d(rows: int, cols: int, wrap: bool = True) -> Topology:
    """2-D (optionally toroidal) mesh — the shape of a TPU pod ICI fabric."""
    def nid(r, c):
        return r * cols + c

    links = set()
    for r in range(rows):
        for c in range(cols):
            if wrap or r + 1 < rows:
                links.add(tuple(sorted((nid(r, c), nid((r + 1) % rows, c)))))
            if wrap or c + 1 < cols:
                links.add(tuple(sorted((nid(r, c), nid(r, (c + 1) % cols)))))
    links = {(a, b) for a, b in links if a != b}
    return from_links(rows * cols, sorted(links), name=f"mesh2d_{rows}x{cols}")


def random_regular(n: int, degree: int, seed: int = 0) -> Topology:
    """Random connected degree-regular-ish graph (for property tests)."""
    rng = np.random.default_rng(seed)
    links = set()
    # Start with a ring to guarantee connectivity.
    for i in range(n):
        links.add(tuple(sorted((i, (i + 1) % n))))
    tries = 0
    while tries < 50 * n and min(np.bincount(np.array(list(links)).ravel(), minlength=n)) < degree:
        a, b = rng.integers(0, n, 2)
        if a != b:
            links.add(tuple(sorted((int(a), int(b)))))
        tries += 1
    return from_links(n, sorted(links), name=f"random_{n}_{degree}")
