"""Monte-Carlo seismic cube generator (§3 + §6.1 of the paper).

A copy of ``repro.data.simulation``: ``load_window`` stays numpy and returns
the same bytes as the reference for every window.

The paper's data comes from the HPC4e seismic benchmark: a 16-layer velocity
model; each layer's Vp is uncertain with a known distribution type (the four
types cycle across layers: normal, lognormal, exponential, uniform); each
simulation draws one Vp vector and produces a 3-D cube of values; n
simulations give every point a set of n observation values.

We reproduce that generative *structure* without the wave-propagation solver:
a point's observation value is a smooth nonlinear mixture of the layer Vp
draws, so that (a) each point's observation set follows (approximately) one
of the candidate distribution types, with the dominant layer determined by
depth (slice index), and (b) neighboring points frequently share identical
(mu, sigma) after float32 rounding — the redundancy the paper's Grouping
method exploits (their simulation outputs are quantized the same way).

Everything is generated lazily per window from a seed — a 2.4 TB dataset is
representable without materializing it, exactly like reading a window of
bytes from NFS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.regions import CubeGeometry, Window

# Layer distribution types cycle every four layers (§3: "The distribution
# type for every four layers are: Normal, Lognormal, Exponential and
# Uniform").
LAYER_TYPE_CYCLE = ("normal", "lognormal", "exponential", "uniform")


@dataclass(frozen=True)
class SimulationConfig:
    geometry: CubeGeometry = CubeGeometry(501, 501, 251)  # Set1 dims (§6.1)
    num_simulations: int = 1000  # observations per point
    num_layers: int = 16
    base_vp: float = 3000.0  # m/s scale of the layered model
    quantize_decimals: int = 3  # output rounding -> grouping redundancy
    group_block: int = 4  # points per line sharing one generator cell
    line_block: int = 2  # consecutive lines sharing generator cells
    seed: int = 0


class SeismicSimulation:
    """Lazy window-addressable observation generator.

    ``load_window(w) -> (num_points, num_simulations) float32``; deterministic
    in (seed, window), so re-loads after a crash return identical data (the
    NFS re-read semantics the paper's restart relies on).
    """

    def __init__(self, config: SimulationConfig = SimulationConfig()):
        self.config = config
        self.geometry = config.geometry
        # Per-layer Vp draws for all simulations: (num_layers, n_sims).
        rng = np.random.default_rng(config.seed)
        n = config.num_simulations
        draws = []
        for layer in range(config.num_layers):
            t = LAYER_TYPE_CYCLE[layer % 4]
            scale = config.base_vp * (1.0 + 0.1 * layer)
            # Parameters chosen so the four families are mutually
            # distinguishable at a few hundred observations (lognormal is
            # visibly skewed, exponential starts at 0, uniform is flat).
            if t == "normal":
                # cv 0.3: wide enough that the (skewed) lognormal MoM fit is
                # clearly worse than the normal fit under Eq. 5.
                draws.append(rng.normal(scale, 0.3 * scale, size=n))
            elif t == "lognormal":
                draws.append(np.exp(rng.normal(np.log(scale), 0.5, size=n)))
            elif t == "exponential":
                draws.append(rng.exponential(scale, size=n))
            else:  # uniform
                draws.append(rng.uniform(0.5 * scale, 1.5 * scale, size=n))
        self._vp = np.asarray(draws, dtype=np.float64)  # (L, n)

    def _dominant_layer(self, slice_i: int) -> int:
        # Slices cycle through the model's layers, so any 4 consecutive
        # slices cover all four distribution types (tree training data).
        return slice_i % self.config.num_layers

    def load_window(self, w: Window) -> np.ndarray:
        """Generate the observation matrix for a window (Algorithm 2's
        GetData over all datasets, vectorized)."""
        cfg = self.config
        geom = self.geometry
        layer = self._dominant_layer(w.slice_i)
        vp = self._vp[layer]  # (n,) dominant layer's draws

        num_pts = w.num_lines * geom.points_per_line
        # Per-generator-cell deterministic spatial modulation. Points within a
        # `group_block` run (and lines within a `line_block` run) share a
        # cell => identical observations — the redundancy §5.2 exploits, both
        # within a window (Grouping) and across windows (Reuse), mirroring
        # the paper's quantized simulation outputs.
        line_idx = np.repeat(
            np.arange(w.line_start, w.line_end) // cfg.line_block,
            geom.points_per_line,
        )
        pt_idx = np.tile(np.arange(geom.points_per_line), w.num_lines)
        cell = pt_idx // cfg.group_block
        # Smooth, deterministic per-cell gains (no RNG: windows independent).
        phase = (
            0.7 * np.sin(0.05 * line_idx + 0.11 * cell)
            + 0.3 * np.cos(0.02 * line_idx * cell / (1.0 + cell))
        )
        gain = 1.0 + 0.05 * phase  # (P,)

        # Observation: the dominant layer's draw through a per-cell
        # MULTIPLICATIVE gain. Scaling through zero preserves all four
        # families exactly (Exp(l)/a = Exp(l*a), logN shifts mu, N scales,
        # U scales), so each point's observation set keeps its layer's type
        # — the paper's 4-types assumption — while cells still differ.
        obs = gain[:, None] * vp[None, :]
        obs = np.round(obs, cfg.quantize_decimals)
        return obs.astype(np.float32).reshape(num_pts, cfg.num_simulations)

    def true_type_index(self, slice_i: int) -> int:
        """Ground-truth dominant distribution type index (into TYPES_4 —
        note TYPES_4 and LAYER_TYPE_CYCLE order differ)."""
        from repro_torch.core.distributions import TYPES_4

        name = LAYER_TYPE_CYCLE[self._dominant_layer(slice_i) % 4]
        return TYPES_4.index(name)

    def nominal_bytes(self) -> int:
        """Dataset size if materialized (for the 235 GB / 2.4 TB analogies)."""
        return self.geometry.total_points * self.config.num_simulations * 4
