"""MPM pipeline (explicit APIC).

Reference call stack (SURVEY §3.3; the flagship workload):
``partition_for_particles`` (sparsity, SparsityCompute.tpp:5-25) ->
``CleanGridBlocks`` -> ``P2GTransfer`` (APIC + constitutive stress fused,
atomic scatter, simulation/transfer/P2G.hpp:26-135) ->
``ComputeGridBlockVelocity`` + ``ApplyBoundaryConditionOnGridBlocks``
(simulation/grid/GridOp.hpp) -> ``G2PTransfer`` (G2P.hpp).

Re-design (the north-star recipe, SURVEY §2.11(5) and §7-M1):

* **No atomics.**  P2G scatter-adds 27 stencil contributions per particle
  into grid cells addressed by ``block_slot * bs^d + offset``; XLA lowers
  the single fused ``scatter-add`` over ``[N*27, 4]`` lanes.  (The
  block-binned matmul formulation lives in :mod:`zpc_tpu.sim.mpm_binned2`
  as the optimized path.)
* **Partitioning** is the sort-based
  :meth:`~zpc_tpu.geometry.sparse_grid.SparseGrid.activate` with a +1 block
  dilation so the quadratic stencil (base..base+2) always lands in active
  blocks.
* **One jitted step.**  The whole step (partition, P2G, grid ops, G2P,
  plasticity, advection) is a single XLA program; ``dt`` is a traced scalar
  so CFL-adaptive stepping never recompiles.
* All per-particle 3x3 math (stress, SVD) is batched elementwise code at fp32
  precision (see :mod:`zpc_tpu.math.vecmat`).

APIC transfer per Jiang et al.; the fused momentum matrix
``A = m C - dt * 4/dx^2 * vol0 * tau`` mirrors the reference's MLS/APIC
P2G fusion (P2G.hpp:87-126).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers.structured import StructuredField, structured_field
from ..core.config import prop
from ..geometry.collider import Collider, resolve_boundaries
from ..geometry.sparse_grid import SparseGrid, neighbor_offsets, sparse_grid
from ..math.interpolation import bspline_weights, stencil_size
from ..math.vecmat import mm
from ..models.constitutive import ElasticModel

__all__ = ["MPMSim", "MPMState", "make_mpm_state", "explicit_step"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MPMSim:
    """Static+physical configuration of an MPM simulation
    (MPMSimulator aggregate, simulation/mpm/Simulator.hpp:13-51)."""

    model: ElasticModel
    gravity: jax.Array                       # [3]
    colliders: Tuple[Collider, ...] = ()
    plasticity: Optional[object] = None
    order: int = dataclasses.field(metadata=dict(static=True), default=2)
    flip: float = dataclasses.field(metadata=dict(static=True), default=0.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MPMState:
    particles: StructuredField   # x, v, F, C, m, vol (+ Jp)
    grid: SparseGrid             # props: m [1], v [3]
    max_vel: jax.Array           # scalar diagnostic (CFL)


def make_mpm_state(x: jax.Array, *, dx: float, rho: float = 1e3,
                   ppc: float = 8.0, block_capacity: int = 4096,
                   velocity: Optional[jax.Array] = None,
                   capacity: Optional[int] = None,
                   with_Jp: bool = False, Jp0: float = 0.0,
                   origin=None) -> MPMState:
    """Build particle + grid state from positions (Scene-builder analog,
    simulation/init/Scene.cpp:36-91).  Dimension (2 or 3) follows x."""
    n, dim = x.shape
    cap = capacity or n
    vol0 = dx ** dim / ppc
    props = [prop("x", dim), prop("v", dim), prop("F", (dim, dim)),
             prop("C", (dim, dim)), prop("m"), prop("vol")]
    if with_Jp:
        props.append(prop("Jp"))
    data = {
        "x": x,
        "v": velocity if velocity is not None else jnp.zeros((n, dim)),
        "F": jnp.broadcast_to(jnp.eye(dim), (n, dim, dim)),
        "C": jnp.zeros((n, dim, dim)),
        "m": jnp.full((n,), rho * vol0),
        "vol": jnp.full((n,), vol0),
    }
    if with_Jp:
        data["Jp"] = jnp.full((n,), Jp0)
    particles = structured_field(props, cap, data=data, size=n)
    grid = sparse_grid([prop("m"), prop("v", dim)], dx=dx,
                       block_capacity=block_capacity, dim=dim,
                       origin=origin)
    return MPMState(particles, grid, jnp.float32(0.0))


def _stencil(sim: MPMSim, grid: SparseGrid, x: jax.Array):
    """Per-particle stencil: base cell, node coords, packed weights.

    Returns (cells [N,S^3,3], w3 [N,S^3], base [N,3], xi [N,3]).
    """
    S = stencil_size(sim.order)
    dim = grid.dim
    xi = grid.world_to_index(x)                       # cell units
    base, w, _ = bspline_weights(xi, sim.order)       # [N,d], [N,d,S]
    offs = jnp.asarray(neighbor_offsets(dim, 0, S - 1))  # [S^d,d] ij-order
    cells = base[:, None, :] + offs[None, :, :]
    # w3[p, o] = prod_d w[p, d, offs[o, d]]
    w3 = jnp.ones((x.shape[0], offs.shape[0]), xi.dtype)
    for d in range(dim):
        w3 = w3 * w[:, d, :][:, offs[:, d]]
    return cells, w3, base, xi


def _apic_dinv(order: int, dx):
    """APIC inertia-tensor inverse D^-1 for the B-spline of given order.

    D = dx^2/4 I (quadratic), dx^2/3 I (cubic); linear has a non-constant
    D so affine transfers are unsupported there (Jiang et al. 2015 §5.3).
    """
    if order == 2:
        return 4.0 / (dx * dx)
    if order == 3:
        return 3.0 / (dx * dx)
    raise NotImplementedError(
        f"APIC affine transfer needs order 2 or 3 B-splines, got {order}")


def explicit_step(sim: MPMSim, state: MPMState, dt) -> MPMState:
    """One explicit symplectic-Euler APIC step — a single XLA program."""
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    dx = grid.dx
    pmask = p.mask
    m = jnp.where(pmask, p["m"], 0.0)

    # -- 1. partition (sparsity, SparsityCompute.tpp) -------------------------
    cells, w3, base, xi = _stencil(sim, grid, p["x"])
    pblock = jnp.floor_divide(base, bs)
    grid = grid.activate(pblock, valid=pmask, dilation=1)

    # -- 2. fused P2G (P2G.hpp:26-135, atomic-free) ---------------------------
    Dinv = _apic_dinv(sim.order, dx)
    F = p["F"]  # already plasticity-projected (end of previous step)
    tau = sim.model.kirchhoff(F)                 # [N,3,3]
    A = m[:, None, None] * p["C"] - (dt * Dinv * jnp.where(
        pmask, p["vol"], 0.0))[:, None, None] * tau
    # node world offsets (x_i - x_p) = (cell - xi) * dx
    xdiff = (cells.astype(xi.dtype) - xi[:, None, :]) * dx   # [N,S^3,3]
    mom = w3[..., None] * (
        m[:, None, None] * p["v"][:, None, :] +
        jnp.einsum("nij,nkj->nki", A, xdiff))
    mass_c = w3 * m[:, None]
    # scatter [N*S^3] lanes into flat grid cells (+1 trash slot)
    slot = grid.cell_slot(cells)                 # [N,S^3], -1 on miss
    slot = jnp.where(slot >= 0, slot, cap_cells)
    payload = jnp.concatenate([mass_c[..., None], mom], -1)  # [N,S^d,1+d]
    acc = jnp.zeros((cap_cells + 1, 1 + dim), payload.dtype)
    acc = acc.at[slot.reshape(-1)].add(
        payload.reshape(-1, 1 + dim))[:cap_cells]
    gm = acc[:, 0]
    gmv = acc[:, 1:]

    # -- 3. grid update (GridOp.hpp:54-86 + boundary :14-38) ------------------
    has_mass = gm > 0.0
    gv0 = jnp.where(has_mass[:, None],
                    gmv / jnp.maximum(gm, 1e-30)[:, None], 0.0)
    gv = gv0 + dt * sim.gravity[None, :]
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[:, None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))
    grid = grid.with_data(
        m=gm.reshape(grid.block_capacity, ncell),
        v=gv.reshape(grid.block_capacity, ncell, dim))

    # -- 4. G2P + advect (G2P.hpp) --------------------------------------------
    safe_slot = jnp.minimum(slot, cap_cells - 1)
    vnode = gv[safe_slot]                         # [N,S^3,3]
    vnode = jnp.where((slot < cap_cells)[..., None], vnode, 0.0)
    v_new = jnp.einsum("nk,nki->ni", w3, vnode)
    B = jnp.einsum("nk,nki,nkj->nij", w3, vnode, xdiff)
    C_new = Dinv * B
    if sim.flip > 0.0:
        # FLIP delta: the grid velocity *change* from forces+boundaries this
        # step, interpolated at particles (pre-update grid velocity = gv0).
        gdv = gv - gv0
        dvnode = jnp.where((slot < cap_cells)[..., None],
                           gdv[safe_slot], 0.0)
        dv = jnp.einsum("nk,nki->ni", w3, dvnode)
        v_new = sim.flip * (p["v"] + dv) + (1.0 - sim.flip) * v_new
    eye = jnp.eye(dim, dtype=F.dtype)
    F_new = mm(eye + dt * C_new, F)
    updates = {}
    if sim.plasticity is not None and p.has_prop("Jp"):
        F_new, Jp_new = sim.plasticity.project(F_new, p["Jp"])
        updates["Jp"] = jnp.where(pmask, Jp_new, p["Jp"])
    x_new = p["x"] + dt * v_new

    mask3 = pmask[:, None]
    particles = p.update(
        x=jnp.where(mask3, x_new, p["x"]),
        v=jnp.where(mask3, v_new, p["v"]),
        F=jnp.where(mask3[..., None], F_new, p["F"]),
        C=jnp.where(mask3[..., None], C_new, p["C"]),
        **updates,
    )
    return MPMState(particles, grid, max_vel)
