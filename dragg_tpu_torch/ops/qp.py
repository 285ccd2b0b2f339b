"""Fixed-shape QP formulation of the per-home MPC (counterpart of
``dragg_tpu/ops/qp.py``).

The (home-type, horizon) template compiles once into numpy index arrays
(``QPLayout``, ``SparsePattern``, ``SchurStructure``, ``build_qp_static``
— the same logic as the JAX package, so sparsity tuples are identical);
each timestep fills per-home float32 tensors (``assemble_qp_step``) on the
batch's device.  Variables per home (superset pv_battery shape; absent
blocks are dropped from a reduced :class:`HomeTypeSpec` layout), horizon H:

    cool[H] heat[H] wh[H] p_ch[H] p_disch[H] u_curt[H]
    T_in_ev[H+1] T_wh_ev[H+1] e_batt[H+1] T_in1 T_wh1        (n = 9H + 5)

Problem form: minimize q'x subject to A_eq x = b_eq, l <= x <= u, with
the linear objective the discounted price on grid power
(dragg/mpc_calc.py:441-446).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch import device as _device  # noqa: F401  (pins TF32 off)
from dragg_tpu_torch import telemetry

TAP_TEMP = 15.0  # assumed cold tap water temp, degC (dragg/mpc_calc.py:181)
BIG = float("inf")
F32 = torch.float32


def _f32(a, device) -> torch.Tensor:
    """Host array → float32 tensor on ``device`` (the cast JAX's x64-off
    ``jnp.asarray`` makes)."""
    return torch.as_tensor(np.asarray(a), dtype=F32, device=device)


class HomeTypeSpec(NamedTuple):
    """Which optional variable/constraint blocks a home type carries.

    The reference builds a different CVXPY program per home type
    (dragg/mpc_calc.py ``manage_home`` dispatch): base homes have no
    battery or PV blocks at all.  A :class:`QPLayout` built on a spec
    drops the absent blocks from the batched program instead of padding
    them to zero-width [0, 0] boxes — the type-bucketed engine solves
    each bucket at its own (n, m) shape (docs/architecture.md §10).

    Scenario blocks (docs/architecture.md §15; no reference analog —
    the reference knows only the four types above):

    * ``has_ev`` — EV charging: ``p_ev_ch`` columns + ``e_ev`` SOC
      evolution with pin/dynamics rows; departure deadlines and
      away-window availability arrive as per-step box bounds (data, not
      structure — :func:`ev_charge_bounds`).
    * ``has_hp`` — heat-pump HVAC: no layout change at all; the thermal
      coefficients of the HVAC dynamics rows become per-step values
      scaled by the OAT-dependent COP curve (:func:`hp_cops`), exactly
      like the water-mix band.
    * ``has_grid`` — explicit grid-power block for community events
      (DR curtailment caps / outage islanding): ``p_gr`` columns pinned
      to the per-step physical grid power by equality rows, so event
      windows are pure per-step box bounds on ``p_gr``.  Enabled
      engine-wide when the scenario timeline contains any grid event
      (never by a home type), so event-free runs keep the historical
      shapes bit-for-bit.
    """

    has_batt: bool          # p_ch / p_disch / e_batt columns + battery rows
    has_curt: bool          # PV curtailment column (objective-only)
    has_ev: bool = False    # EV charge column + SOC pin/dynamics rows
    has_hp: bool = False    # COP-scaled HVAC thermal coefficients (per-step)
    has_grid: bool = False  # explicit p_grid columns + defining rows


SUPERSET_SPEC = HomeTypeSpec(has_batt=True, has_curt=True)

# Home type name (dragg_tpu.homes.HOME_TYPES) → block spec.
TYPE_SPECS: dict[str, HomeTypeSpec] = {
    "pv_battery": SUPERSET_SPEC,
    "pv_only": HomeTypeSpec(has_batt=False, has_curt=True),
    "battery_only": HomeTypeSpec(has_batt=True, has_curt=False),
    "base": HomeTypeSpec(has_batt=False, has_curt=False),
    "ev": HomeTypeSpec(has_batt=False, has_curt=False, has_ev=True),
    "heat_pump": HomeTypeSpec(has_batt=False, has_curt=False, has_hp=True),
}


def superset_spec_for(type_code) -> HomeTypeSpec:
    """The shape the one-batch (unbucketed) engine pads every home to:
    the HISTORICAL superset (pv_battery — the floor, so every legacy
    population keeps its pre-scenario program byte-for-byte, dead [0, 0]
    battery/PV boxes included) unioned with the scenario blocks of the
    types actually present — EV columns appear only when some home
    carries them, and the heat-pump COP band only when some home scales
    by it."""
    from dragg_tpu_torch.homes import HOME_TYPES

    present = {HOME_TYPES[int(c)]
               for c in np.unique(np.asarray(type_code))}
    specs = [SUPERSET_SPEC] + [TYPE_SPECS[t] for t in present]
    return HomeTypeSpec(*[any(getattr(s, f) for s in specs)
                          for f in HomeTypeSpec._fields])


# Heat-pump COP curve (docs/architecture.md §15): linear in OAT, clipped.
# Heating COP improves with warmer outdoor air; cooling COP degrades as
# the heat-rejection lift grows above HP_COOL_PIVOT.  Resistive homes are
# the COP == 1 special case (the assemble path multiplies by 1 exactly).
HP_COP_MIN = 1.0
HP_COP_MAX = 6.0
HP_COOL_PIVOT = 30.0  # degC: cooling COP = base at this OAT


def hp_cops(oat, cop_base, cop_slope):
    """(cool_cop, heat_cop) for an OAT window — broadcastable: ``oat`` is
    (H,) or (n, H), ``cop_base``/``cop_slope`` are (n,) or (n, 1)."""
    base, slope = cop_base, cop_slope
    if base.ndim == 1:
        base, slope = base[:, None], slope[:, None]
    oat2 = oat if oat.ndim == 2 else oat[None, :]
    heat = torch.clamp(base + slope * oat2, HP_COP_MIN, HP_COP_MAX)
    cool = torch.clamp(base + slope * (HP_COOL_PIVOT - oat2),
                       HP_COP_MIN, HP_COP_MAX)
    return cool, heat


def ev_charge_bounds(hod_ctrl, hod_state, batch, e_ev_init, dt, eps=1e-3):
    """Per-step EV box data for one assembled timestep: ``(avail, floor)``,
    both (n, H).  ``avail[k]`` is 1 when the vehicle is home at control
    step k; ``floor[k]`` lower-bounds ``e_ev[k+1]``: during away hours the
    departure target, relaxed to the reachable SOC minus ``eps``."""
    is_ev = batch.is_ev[:, None]
    a_start = batch.ev_away_start[:, None]
    a_end = batch.ev_away_end[:, None]
    hod_c = hod_ctrl[None, :]
    hod_s = hod_state[None, :]
    away_c = (hod_c >= a_start) & (hod_c < a_end)
    avail = is_ev * (1.0 - away_c.to(F32))
    rate = batch.ev_rate[:, None]
    eff = batch.ev_ch_eff[:, None]
    reach = e_ev_init[:, None] + torch.cumsum(avail * rate * eff / dt, dim=1)
    away_s = (hod_s >= a_start) & (hod_s < a_end)
    target = batch.ev_target_kwh[:, None]
    floor = torch.where(away_s & (is_ev > 0),
                        torch.minimum(target, reach - eps),
                        torch.zeros((), dtype=F32, device=reach.device))
    return avail, torch.clamp(floor, min=0.0)


class QPLayout:
    """Index bookkeeping for the per-home variable vector and equality rows.

    Default spec is the superset (pv_battery) shape, whose indices are
    identical to the historical fixed layout (n = 9H + 5, m_eq = 3H + 5).
    Under a reduced :class:`HomeTypeSpec` the absent blocks' indices are
    ``None`` so any unguarded use fails loudly instead of aliasing a live
    column."""

    def __init__(self, horizon: int, spec: HomeTypeSpec = SUPERSET_SPEC):
        H = int(horizon)
        self.H = H
        self.spec = spec
        self.has_batt = bool(spec.has_batt)
        self.has_curt = bool(spec.has_curt)
        self.has_ev = bool(spec.has_ev)
        self.has_hp = bool(spec.has_hp)
        self.has_grid = bool(spec.has_grid)
        i = 0
        self.i_cool = i; i += H          # noqa: E702 — index table reads as one block
        self.i_heat = i; i += H          # noqa: E702
        self.i_wh = i; i += H            # noqa: E702
        if self.has_batt:
            self.i_pch = i; i += H       # noqa: E702
            self.i_pd = i; i += H        # noqa: E702
        else:
            self.i_pch = self.i_pd = None
        if self.has_ev:
            self.i_evch = i; i += H      # noqa: E702
        else:
            self.i_evch = None
        if self.has_curt:
            self.i_curt = i; i += H      # noqa: E702
        else:
            self.i_curt = None
        if self.has_grid:
            self.i_pgr = i; i += H       # noqa: E702
        else:
            self.i_pgr = None
        self.i_tin = i; i += H + 1       # noqa: E702
        self.i_twh = i; i += H + 1       # noqa: E702
        if self.has_batt:
            self.i_eb = i; i += H + 1    # noqa: E702
        else:
            self.i_eb = None
        if self.has_ev:
            self.i_eev = i; i += H + 1   # noqa: E702
        else:
            self.i_eev = None
        self.i_tin1 = i; i += 1          # noqa: E702
        self.i_twh1 = i; i += 1          # noqa: E702
        self.n = i
        # Equality rows.
        r = 0
        self.r_tin0 = r; r += 1          # noqa: E702
        self.r_tind = r; r += H          # noqa: E702  (H rows)
        self.r_twh0 = r; r += 1          # noqa: E702
        self.r_twhd = r; r += H          # noqa: E702  (H rows)
        self.r_tin1 = r; r += 1          # noqa: E702
        self.r_twh1 = r; r += 1          # noqa: E702
        if self.has_batt:
            self.r_eb0 = r; r += 1       # noqa: E702
            self.r_ebd = r; r += H       # noqa: E702  (H rows)
        else:
            self.r_eb0 = self.r_ebd = None
        if self.has_ev:
            self.r_eev0 = r; r += 1      # noqa: E702
            self.r_eevd = r; r += H      # noqa: E702  (H rows)
        else:
            self.r_eev0 = self.r_eevd = None
        if self.has_grid:
            self.r_pgr = r; r += H       # noqa: E702  (H rows)
        else:
            self.r_pgr = None
        self.m_eq = r
        self.m = self.m_eq + self.n


class SparsePattern(NamedTuple):
    """Static gather-padded sparsity of A_eq, shared across homes.

    The dynamics matrix has ≤``K`` nonzeros per row and ≤``Kc`` per column
    (banded RC recurrences), so both matvec directions become pure gathers +
    elementwise sums, with no scatter in the hot loop.  ``*_src`` index the
    flat nnz axis (-1 → empty slot, masked to 0).

    All index structures are nested int tuples, so the pattern is hashable.
    """

    m: int                    # equality rows
    n: int                    # variables
    nnz: int
    rows: tuple               # (nnz,) row of each entry
    cols: tuple               # (nnz,) col of each entry
    row_cols: tuple           # (m, K) column index per row slot (0-padded)
    row_src: tuple            # (m, K) nnz index per row slot (-1-padded)
    col_rows: tuple           # (n, Kc) row index per col slot (0-padded)
    col_src: tuple            # (n, Kc) nnz index per col slot (-1-padded)


def _tt(a: np.ndarray) -> tuple:
    """ndarray → nested tuple (hashable)."""
    if a.ndim == 1:
        return tuple(int(v) for v in a)
    return tuple(tuple(int(v) for v in row) for row in a)


def _build_pattern(rows: np.ndarray, cols: np.ndarray, m: int, n: int) -> SparsePattern:
    nnz = len(rows)
    K = int(np.bincount(rows, minlength=m).max())
    Kc = int(np.bincount(cols, minlength=n).max())
    row_cols = np.zeros((m, K), dtype=np.int32)
    row_src = np.full((m, K), -1, dtype=np.int32)
    col_rows = np.zeros((n, Kc), dtype=np.int32)
    col_src = np.full((n, Kc), -1, dtype=np.int32)
    rfill = np.zeros(m, dtype=np.int64)
    cfill = np.zeros(n, dtype=np.int64)
    for e in range(nnz):
        r, c = int(rows[e]), int(cols[e])
        row_cols[r, rfill[r]] = c
        row_src[r, rfill[r]] = e
        rfill[r] += 1
        col_rows[c, cfill[c]] = r
        col_src[c, cfill[c]] = e
        cfill[c] += 1
    return SparsePattern(m=m, n=n, nnz=nnz, rows=_tt(rows), cols=_tt(cols),
                         row_cols=_tt(row_cols), row_src=_tt(row_src),
                         col_rows=_tt(col_rows), col_src=_tt(col_src))


class SchurStructure(NamedTuple):
    """Static structure for forming S = A D⁻¹ Aᵀ directly from the sparse
    values, without materializing the dense (B, m, n) A (at 100k homes ×
    H=48 the dense float32 A alone would be ~26 GB).

    S_ij = Σ_k Dinv_k · A_ik · A_jk — the sum runs over columns k shared by
    rows i and j.  For the banded RC pattern (≤4 nnz/row·col) the number of
    (i, j, k) triples is O(m), so S formation drops from 2Bm²n FLOPs + Bmn
    memory to a few gathers over (B, n_s, P) with n_s = nnz(S), P = max
    shared columns per (i, j).
    """

    n_s: int          # number of stored S entries (full matrix, both triangles)
    P: int            # max (e1, e2) pairs per S entry
    s_rows: tuple     # (n_s,) row of each S entry
    s_cols: tuple     # (n_s,)
    e1: tuple         # (n_s, P) first-factor nnz index (0-padded)
    e2: tuple         # (n_s, P) second-factor nnz index (0-padded)
    kcol: tuple       # (n_s, P) shared column index for the Dinv gather (0-padded)
    mask: tuple       # (n_s, P) 1/0 valid-slot mask


def build_schur_structure(pat: SparsePattern) -> SchurStructure:
    """Precompute the (i, j, k) triple lists of S = A D⁻¹ Aᵀ for a sparse
    pattern.  Cost is O(Σ_k c_k²) with c_k the column counts — tiny for the
    banded MPC pattern, and computed once per (horizon, home-type) shape."""
    from collections import defaultdict

    rows = np.asarray(pat.rows)
    cols = np.asarray(pat.cols)
    by_col: dict[int, list[int]] = defaultdict(list)
    for e in range(pat.nnz):
        by_col[int(cols[e])].append(e)
    pairs: dict[tuple[int, int], list[tuple[int, int, int]]] = defaultdict(list)
    for k, es in by_col.items():
        for a in es:
            for bb in es:
                pairs[(int(rows[a]), int(rows[bb]))].append((a, bb, k))
    n_s = len(pairs)
    P = max(len(v) for v in pairs.values())
    s_rows = np.zeros(n_s, dtype=np.int32)
    s_cols = np.zeros(n_s, dtype=np.int32)
    e1 = np.zeros((n_s, P), dtype=np.int32)
    e2 = np.zeros((n_s, P), dtype=np.int32)
    kcol = np.zeros((n_s, P), dtype=np.int32)
    mask = np.zeros((n_s, P), dtype=np.int32)
    for idx, ((i, j), lst) in enumerate(sorted(pairs.items())):
        s_rows[idx] = i
        s_cols[idx] = j
        for p, (a, bb, k) in enumerate(lst):
            e1[idx, p] = a
            e2[idx, p] = bb
            kcol[idx, p] = k
            mask[idx, p] = 1
    return SchurStructure(n_s=n_s, P=P, s_rows=_tt(s_rows), s_cols=_tt(s_cols),
                          e1=_tt(e1), e2=_tt(e2), kcol=_tt(kcol), mask=_tt(mask))


def schur_index(ss: SchurStructure, device) -> tuple[torch.Tensor, ...]:
    """A SchurStructure's triple lists (e1, e2, kcol, mask) as tensors on
    ``device`` — built once per solve, read every iteration.  Each of the
    four copies from the host's memory waits for the card."""
    telemetry.inc("engine.host_syncs", 4)
    e1, e2, kcol = (torch.as_tensor(a, dtype=torch.long, device=device)
                    for a in (ss.e1, ss.e2, ss.kcol))
    return e1, e2, kcol, torch.as_tensor(ss.mask, dtype=F32, device=device)


def schur_contrib(index, vals_s, Dinv) -> torch.Tensor:
    """Per-entry values of S = Â D⁻¹ Âᵀ ((B, n_s), aligned with
    ss.s_rows/s_cols) from the triple lists ``index = schur_index(ss)``."""
    e1, e2, kcol, mask = index
    return torch.sum(vals_s[:, e1] * vals_s[:, e2] * Dinv[:, kcol] * mask[None],
                     dim=2)


def scatter_schur(ss: SchurStructure, m: int, contrib) -> torch.Tensor:
    """Schur entry values (B, n_s) → dense (B, m, m)."""
    S = contrib.new_zeros((contrib.shape[0], m, m))
    S[:, torch.as_tensor(ss.s_rows, dtype=torch.long, device=contrib.device),
      torch.as_tensor(ss.s_cols, dtype=torch.long, device=contrib.device)] = contrib
    return S


def form_schur_sparse(ss: SchurStructure, m: int, vals_s, Dinv, index=None) -> torch.Tensor:
    """The dense (B, m, m) S = Â D⁻¹ Âᵀ from the sparse values via the
    triple lists, with no dense A anywhere.  ``index`` is
    ``schur_index(ss, device)``, if already built."""
    return scatter_schur(ss, m, schur_contrib(index or schur_index(ss, vals_s.device),
                                              vals_s, Dinv))


def densify_A(pat: SparsePattern, vals: torch.Tensor) -> torch.Tensor:
    """The dense (B, m, n) A_eq from the sparse values (tests and CPU
    cross-checks); duplicate entries add."""
    B = vals.shape[0]
    flat = torch.as_tensor(np.asarray(pat.rows) * pat.n + np.asarray(pat.cols),
                           dtype=torch.long, device=vals.device)
    return vals.new_zeros((B, pat.m * pat.n)).index_add_(1, flat, vals).reshape(
        B, pat.m, pat.n)


_NO_POS = np.zeros(0, dtype=np.int64)  # empty per-step-band position sentinel


class HomeQPStatic(NamedTuple):
    """Per-home static pieces: the (row, col) sparsity (shared, numpy) plus
    the per-home float32 coefficient tensors and the positions of the
    timestep-varying bands (water mix; heat-pump COP; grid-row PV)."""

    rows: np.ndarray          # (nnz,) shared across homes
    cols: np.ndarray          # (nnz,)
    vals: torch.Tensor        # (n_homes, nnz) — static values; per-step bands filled at assemble
    whmix_pos: np.ndarray     # (H,) positions in the nnz axis of the wh-mix coefficients
    pattern: SparsePattern    # gather-padded sparsity for the solver hot loop
    a_in: torch.Tensor        # (n_homes,) 3600 / (C * dt)
    a_wh: torch.Tensor        # (n_homes,) 3600 / (wh_c * dt)
    kin: torch.Tensor         # (n_homes,) 1 - a_in / R
    kwh: torch.Tensor         # (n_homes,) 1 - a_wh / wh_r
    awr: torch.Tensor         # (n_homes,) a_wh / wh_r
    hp_cool_pos: np.ndarray = _NO_POS   # (H+1,) cool-duty thermal entries
    hp_heat_pos: np.ndarray = _NO_POS   # (H+1,) heat-duty thermal entries
    gridpv_pos: np.ndarray = _NO_POS    # (H,)


def build_qp_static(batch, horizon: int, dt: int,
                    spec: HomeTypeSpec = SUPERSET_SPEC,
                    device="cpu") -> HomeQPStatic:
    """Equality-constraint sparsity + per-home coefficients.  ``batch`` is a
    host (numpy float64) HomeBatch; the coefficients are computed in
    float64 and cast to float32 tensors on ``device`` — the same points at
    which the JAX package casts."""
    lay = QPLayout(horizon, spec)
    H = lay.H
    n_homes = batch.hvac_r.shape[0]

    a_in = 3600.0 / (np.asarray(batch.hvac_c) * dt)
    a_wh = 3600.0 / (np.asarray(batch.wh_c) * dt)
    R = np.asarray(batch.hvac_r)
    wh_r = np.asarray(batch.wh_r)
    kin = 1.0 - a_in / R
    kwh = 1.0 - a_wh / wh_r
    awr = a_wh / wh_r
    pc = np.asarray(batch.hvac_p_c)
    ph = np.asarray(batch.hvac_p_h)
    pwh = np.asarray(batch.wh_p)
    che = np.asarray(batch.batt_ch_eff)
    dse = np.asarray(batch.batt_disch_eff)

    rows, cols, vals = [], [], []
    whmix_pos = np.zeros(H, dtype=np.int64)
    hp_cool_pos = (np.zeros(H + 1, dtype=np.int64) if lay.has_hp
                   else _NO_POS)
    hp_heat_pos = (np.zeros(H + 1, dtype=np.int64) if lay.has_hp
                   else _NO_POS)
    gridpv_pos = (np.zeros(H, dtype=np.int64)
                  if lay.has_grid and lay.has_curt else _NO_POS)

    def add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(np.broadcast_to(v, (n_homes,)).astype(np.float64))
        return len(rows) - 1

    # Indoor temp: T[0] pin + dynamics (dragg/mpc_calc.py:313-317); the
    # heat-pump COP band scales these duty coefficients at assemble time.
    add(lay.r_tin0, lay.i_tin, 1.0)
    for k in range(H):
        add(lay.r_tind + k, lay.i_tin + k + 1, 1.0)
        add(lay.r_tind + k, lay.i_tin + k, -kin)
        pos_c = add(lay.r_tind + k, lay.i_cool + k, a_in * pc)
        pos_h = add(lay.r_tind + k, lay.i_heat + k, -a_in * ph)
        if lay.has_hp:
            hp_cool_pos[k] = pos_c
            hp_heat_pos[k] = pos_h
    # WH temp: T[0] pin + dynamics with draw mixing (dragg/mpc_calc.py:329-332).
    add(lay.r_twh0, lay.i_twh, 1.0)
    for k in range(H):
        add(lay.r_twhd + k, lay.i_twh + k + 1, 1.0)
        whmix_pos[k] = add(lay.r_twhd + k, lay.i_twh + k, 0.0)  # -rem[k+1]*kwh, per step
        add(lay.r_twhd + k, lay.i_tin + k + 1, -awr)
        add(lay.r_twhd + k, lay.i_wh + k, -a_wh * pwh)
    # One-step deterministic temps (dragg/mpc_calc.py:321-324,336-338).
    add(lay.r_tin1, lay.i_tin1, 1.0)
    pos_c1 = add(lay.r_tin1, lay.i_cool, a_in * pc)
    pos_h1 = add(lay.r_tin1, lay.i_heat, -a_in * ph)
    if lay.has_hp:
        hp_cool_pos[H] = pos_c1
        hp_heat_pos[H] = pos_h1
    add(lay.r_twh1, lay.i_twh1, 1.0)
    add(lay.r_twh1, lay.i_tin + 1, -awr)
    add(lay.r_twh1, lay.i_wh, -a_wh * pwh)
    # Battery SoC: pin + dynamics (dragg/mpc_calc.py:363-372).
    if lay.has_batt:
        add(lay.r_eb0, lay.i_eb, 1.0)
        for k in range(H):
            add(lay.r_ebd + k, lay.i_eb + k + 1, 1.0)
            add(lay.r_ebd + k, lay.i_eb + k, -1.0)
            add(lay.r_ebd + k, lay.i_pch + k, -che / dt)
            add(lay.r_ebd + k, lay.i_pd + k, -1.0 / (dse * dt))
    # EV SOC: pin + charge-only dynamics.
    if lay.has_ev:
        evche = np.asarray(batch.ev_ch_eff)
        add(lay.r_eev0, lay.i_eev, 1.0)
        for k in range(H):
            add(lay.r_eevd + k, lay.i_eev + k + 1, 1.0)
            add(lay.r_eevd + k, lay.i_eev + k, -1.0)
            add(lay.r_eevd + k, lay.i_evch + k, -evche / dt)
    # Explicit grid power: p_gr − Σ load/storage terms − pvc[k]·u_curt = −pvc[k].
    if lay.has_grid:
        for k in range(H):
            add(lay.r_pgr + k, lay.i_pgr + k, 1.0)
            add(lay.r_pgr + k, lay.i_cool + k, -pc)
            add(lay.r_pgr + k, lay.i_heat + k, -ph)
            add(lay.r_pgr + k, lay.i_wh + k, -pwh)
            if lay.has_batt:
                add(lay.r_pgr + k, lay.i_pch + k, -1.0)
                add(lay.r_pgr + k, lay.i_pd + k, -1.0)
            if lay.has_ev:
                add(lay.r_pgr + k, lay.i_evch + k, -1.0)
            if lay.has_curt:
                gridpv_pos[k] = add(lay.r_pgr + k, lay.i_curt + k, 0.0)

    rows_np = np.array(rows, dtype=np.int64)
    cols_np = np.array(cols, dtype=np.int64)
    return HomeQPStatic(
        rows=rows_np,
        cols=cols_np,
        vals=_f32(np.stack(vals, axis=1), device),
        whmix_pos=whmix_pos,
        pattern=_build_pattern(rows_np, cols_np, lay.m_eq, lay.n),
        a_in=_f32(a_in, device),
        a_wh=_f32(a_wh, device),
        kin=_f32(kin, device),
        kwh=_f32(kwh, device),
        awr=_f32(awr, device),
        hp_cool_pos=hp_cool_pos,
        hp_heat_pos=hp_heat_pos,
        gridpv_pos=gridpv_pos,
    )


class QPStep(NamedTuple):
    """One timestep's batched QP: A_eq values on the static pattern, RHS,
    box bounds and the (unscaled) linear cost, all (n_homes, ·) float32."""

    vals: torch.Tensor    # (n_homes, nnz)
    b_eq: torch.Tensor    # (n_homes, m_eq)
    l_box: torch.Tensor   # (n_homes, n)
    u_box: torch.Tensor   # (n_homes, n)
    q: torch.Tensor       # (n_homes, n)


def _rows2(a: torch.Tensor) -> torch.Tensor:
    """A shared (H+1,) window or per-home (n, H+1) windows, as 2-D."""
    return a if a.ndim == 2 else a[None, :]


def assemble_qp_step(
    static: HomeQPStatic,
    lay: QPLayout,
    batch,
    *,
    oat_window,        # (H+1,) or (n_homes, H+1): OAT at t+k
    ghi_window,        # (H+1,) or (n_homes, H+1): GHI at t+k
    price_total,       # (n_homes, H) discounting NOT applied; rp + tou
    draw_frac,         # (n_homes, H+1) draw fractions for this step (index 0 = current)
    temp_in_init,      # (n_homes,)
    temp_wh_init,      # (n_homes,) AFTER draw mixing
    e_batt_init,       # (n_homes,)
    cool_cap,          # (n_homes,) seasonal duty cap (0 or s)
    heat_cap,          # (n_homes,)
    wh_cap: float,     # s
    discount,          # scalar
    e_ev_init=None,    # (n_homes,) EV SOC kWh (required when lay.has_ev)
    ev_avail=None,     # (n_homes, H) 0/1 charge availability (None = always)
    ev_floor=None,     # (n_homes, H) e_ev[k+1] lower bound (None = 0)
    grid_cap=None,     # (n_homes, H) p_gr upper bound (None = +inf)
    grid_floor=None,   # (n_homes, H) p_gr lower bound (None = -inf)
    comfort_relax=None,  # (n_homes, H) degC indoor-band widening
) -> QPStep:
    """Fill the per-timestep QP (counterpart of
    ``dragg_tpu.ops.qp.assemble_qp_step``, same arithmetic in float32):
    A_eq values (water-mix band; HP COP band and grid-row PV terms under
    scenario specs), RHS, box bounds (seasonal HVAC gating,
    dragg/mpc_calc.py:298-309) and the linear objective q.  Every tensor
    argument lies on the batch's device; the window/price/init tensors
    are float32 (``draw_frac`` may be float64 and is cast, as JAX does)."""
    H = lay.H
    n_homes, dev = static.vals.shape[0], static.vals.device
    draw_frac = draw_frac.to(F32)

    rem = 1.0 - draw_frac  # remainder_frac (dragg/mpc_calc.py:202-204)
    vals = static.vals.clone()
    # Indexing by a host array copies it to the card, which waits for the
    # card: once a read or a write, twice an update in place.
    telemetry.inc("engine.host_syncs")
    vals[:, static.whmix_pos] = -(rem[:, 1:] * static.kwh[:, None])
    oat = _rows2(oat_window)
    ghi = _rows2(ghi_window)
    if len(static.hp_cool_pos):
        # Heat-pump COP band: the HVAC thermal coefficients scale by
        # COP(OAT) per step; resistive homes multiply by exactly 1.0.
        is_hp = batch.is_hp[:, None]
        cop_c, cop_h = hp_cops(oat[:, 1:H + 1], batch.hp_cop_base,
                               batch.hp_cop_slope)
        cop_c = 1.0 + is_hp * (cop_c - 1.0)
        cop_h = 1.0 + is_hp * (cop_h - 1.0)
        cop_c_full = torch.cat([cop_c, cop_c[:, :1]], dim=1)
        cop_h_full = torch.cat([cop_h, cop_h[:, :1]], dim=1)
        telemetry.inc("engine.host_syncs", 4)
        vals[:, static.hp_cool_pos] *= cop_c_full
        vals[:, static.hp_heat_pos] *= cop_h_full
    # PV per kW of GHI (shared by the grid rows and the curtailment cost).
    pvc = (batch.pv_area[:, None] * batch.pv_eff[:, None]
           * batch.has_pv[:, None] * ghi[:, :H] / 1000.0)
    if lay.has_grid and lay.has_curt:
        telemetry.inc("engine.host_syncs")
        vals[:, static.gridpv_pos] = -pvc

    b = torch.zeros((n_homes, lay.m_eq), dtype=F32, device=dev)
    b[:, lay.r_tin0] = temp_in_init
    b[:, lay.r_tind: lay.r_tind + H] = (
        (static.a_in[:, None] / batch.hvac_r[:, None]) * oat[:, 1: H + 1])
    b[:, lay.r_twh0] = temp_wh_init
    b[:, lay.r_twhd: lay.r_twhd + H] = (
        draw_frac[:, 1:] * TAP_TEMP * static.kwh[:, None])
    b[:, lay.r_tin1] = (temp_in_init * static.kin
                        + static.a_in / batch.hvac_r * oat[:, 1])
    b[:, lay.r_twh1] = temp_wh_init * static.kwh
    if lay.has_batt:
        b[:, lay.r_eb0] = e_batt_init
    if lay.has_ev:
        b[:, lay.r_eev0] = 0.0 if e_ev_init is None else e_ev_init
    if lay.has_grid and lay.has_curt:
        b[:, lay.r_pgr: lay.r_pgr + H] = -pvc

    l = torch.zeros((n_homes, lay.n), dtype=F32, device=dev)
    u = torch.zeros((n_homes, lay.n), dtype=F32, device=dev)

    def seg(lo, hi, i0, length):
        l[:, i0: i0 + length] = lo[:, None] if torch.is_tensor(lo) else lo
        u[:, i0: i0 + length] = hi[:, None] if torch.is_tensor(hi) else hi

    seg(0.0, cool_cap, lay.i_cool, H)
    seg(0.0, heat_cap, lay.i_heat, H)
    seg(0.0, float(wh_cap), lay.i_wh, H)
    if lay.has_batt:
        rate = batch.batt_max_rate * batch.has_batt
        seg(0.0, rate, lay.i_pch, H)
        seg(-rate, 0.0, lay.i_pd, H)
    if lay.has_ev:
        ev_rate = (batch.ev_rate * batch.is_ev)[:, None]
        u[:, lay.i_evch: lay.i_evch + H] = (
            ev_rate * ev_avail if ev_avail is not None else ev_rate)
    if lay.has_curt:
        seg(0.0, 1.0, lay.i_curt, H)
    if lay.has_grid:
        l[:, lay.i_pgr: lay.i_pgr + H] = (
            grid_floor if grid_floor is not None else -BIG)
        u[:, lay.i_pgr: lay.i_pgr + H] = (
            grid_cap if grid_cap is not None else BIG)
    # T_in_ev[0] is pinned by equality; bounds apply to [1:] only
    # (dragg/mpc_calc.py:318-319); DR/outage windows widen the band.
    seg(-BIG, BIG, lay.i_tin, 1)
    tin_lo = batch.temp_in_min[:, None]
    tin_hi = batch.temp_in_max[:, None]
    if comfort_relax is not None:
        l[:, lay.i_tin + 1: lay.i_tin + 1 + H] = tin_lo - comfort_relax
        u[:, lay.i_tin + 1: lay.i_tin + 1 + H] = tin_hi + comfort_relax
    else:
        seg(batch.temp_in_min, batch.temp_in_max, lay.i_tin + 1, H)
    # T_wh_ev bounds apply to ALL H+1 entries including the pinned index 0
    # (dragg/mpc_calc.py:333-334): an out-of-band initial WH temp makes the
    # problem infeasible and routes the home to the fallback controller.
    seg(batch.temp_wh_min, batch.temp_wh_max, lay.i_twh, H + 1)
    if lay.has_batt:
        seg(-BIG, BIG, lay.i_eb, 1)
        seg(batch.batt_cap_min, batch.batt_cap_max, lay.i_eb + 1, H)
    if lay.has_ev:
        seg(-BIG, BIG, lay.i_eev, 1)  # e_ev[0] pinned by equality
        l[:, lay.i_eev + 1: lay.i_eev + 1 + H] = (
            ev_floor if ev_floor is not None else 0.0)
        u[:, lay.i_eev + 1: lay.i_eev + 1 + H] = (batch.ev_cap * batch.is_ev)[:, None]
    if comfort_relax is not None:
        l[:, lay.i_tin1] = tin_lo[:, 0] - comfort_relax[:, 0]
        u[:, lay.i_tin1] = tin_hi[:, 0] + comfort_relax[:, 0]
    else:
        seg(batch.temp_in_min, batch.temp_in_max, lay.i_tin1, 1)
    seg(batch.temp_wh_min, batch.temp_wh_max, lay.i_twh1, 1)

    # Objective: sum_k w[k] * price[k] * p_grid[k], p_grid affine in the
    # controls (dragg/mpc_calc.py:342,387-432,441-446).
    s = float(wh_cap)
    telemetry.inc("engine.host_syncs")  # the discount's copy to the card
    w = torch.pow(torch.tensor(float(discount), dtype=F32, device=dev),
                  torch.arange(H, dtype=F32, device=dev))
    wp = w[None, :] * price_total
    q = torch.zeros((n_homes, lay.n), dtype=F32, device=dev)
    q[:, lay.i_cool: lay.i_cool + H] = wp * (s * batch.hvac_p_c)[:, None]
    q[:, lay.i_heat: lay.i_heat + H] = wp * (s * batch.hvac_p_h)[:, None]
    q[:, lay.i_wh: lay.i_wh + H] = wp * (s * batch.wh_p)[:, None]
    if lay.has_batt:
        q[:, lay.i_pch: lay.i_pch + H] = wp * s
        q[:, lay.i_pd: lay.i_pd + H] = wp * s
    if lay.has_ev:
        q[:, lay.i_evch: lay.i_evch + H] = wp * s
    if lay.has_curt:
        # PV: p_grid -= s * pvc[k] * (1 - u_curt[k]); the constant term is
        # dropped, the u_curt coefficient is +w*price*s*pvc.
        q[:, lay.i_curt: lay.i_curt + H] = wp * s * pvc
    return QPStep(vals=vals, b_eq=b, l_box=l, u_box=u, q=q)


def shift_warm_start(x, lay: QPLayout):
    """Shift a stacked variable (or box-dual) vector one step along the
    horizon for warm-starting the next timestep's solve: the previous
    plan's entry for t+k+1 seeds the new entry for t+k, the final entry
    repeated."""
    H = lay.H
    x = x.clone()
    for i0, L in ((lay.i_cool, H), (lay.i_heat, H), (lay.i_wh, H),
                  (lay.i_pch, H), (lay.i_pd, H), (lay.i_evch, H),
                  (lay.i_curt, H), (lay.i_pgr, H), (lay.i_tin, H + 1),
                  (lay.i_twh, H + 1), (lay.i_eb, H + 1), (lay.i_eev, H + 1)):
        if i0 is not None:
            x[:, i0: i0 + L - 1] = x[:, i0 + 1: i0 + L].clone()
    return x


class MPCSolution(NamedTuple):
    """Recovered per-home horizon series (raw duty units, kW, degC, kWh)."""

    cool: torch.Tensor      # (n_homes, H) raw duty [0, s]
    heat: torch.Tensor
    wh: torch.Tensor
    p_ch: torch.Tensor
    p_disch: torch.Tensor
    u_curt: torch.Tensor
    p_pv: torch.Tensor      # (n_homes, H)
    p_load: torch.Tensor    # (n_homes, H) total community-units load (pre /s)
    p_grid: torch.Tensor    # (n_homes, H)
    cost: torch.Tensor      # (n_homes, H) price * p_grid (undiscounted)
    temp_in_ev: torch.Tensor  # (n_homes, H+1)
    temp_wh_ev: torch.Tensor
    e_batt: torch.Tensor      # (n_homes, H+1)
    temp_in1: torch.Tensor    # (n_homes,) one-step deterministic indoor temp
    temp_wh1: torch.Tensor
    p_ev_ch: torch.Tensor     # (n_homes, H) EV charge kW (zeros when absent)
    e_ev: torch.Tensor        # (n_homes, H+1) EV SOC kWh (zeros when absent)


def recover_solution(x, lay: QPLayout, batch, ghi_window, price_total, s: float) -> MPCSolution:
    """Extract physical series from the stacked variable vector and rebuild
    the eliminated p_load / p_pv / p_grid / cost
    (dragg/mpc_calc.py:342,380-432,444); absent blocks come back as zeros."""
    H = lay.H
    B = x.shape[0]
    zH = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    zH1 = torch.zeros((B, H + 1), dtype=x.dtype, device=x.device)
    cool = x[:, lay.i_cool: lay.i_cool + H]
    heat = x[:, lay.i_heat: lay.i_heat + H]
    wh = x[:, lay.i_wh: lay.i_wh + H]
    p_ch = x[:, lay.i_pch: lay.i_pch + H] if lay.has_batt else zH
    p_disch = x[:, lay.i_pd: lay.i_pd + H] if lay.has_batt else zH
    u_curt = x[:, lay.i_curt: lay.i_curt + H] if lay.has_curt else zH
    ghi = _rows2(ghi_window)[:, :H]
    pvc = (batch.pv_area[:, None] * batch.pv_eff[:, None]
           * batch.has_pv[:, None] * ghi / 1000.0)
    p_pv = pvc * (1.0 - u_curt)
    p_ev = x[:, lay.i_evch: lay.i_evch + H] if lay.has_ev else zH
    p_load = s * (batch.hvac_p_c[:, None] * cool
                  + batch.hvac_p_h[:, None] * heat
                  + batch.wh_p[:, None] * wh)
    p_grid = p_load + s * (p_ch + p_disch + p_ev) - s * p_pv
    cost = price_total * p_grid
    return MPCSolution(
        cool=cool, heat=heat, wh=wh, p_ch=p_ch, p_disch=p_disch, u_curt=u_curt,
        p_pv=p_pv, p_load=p_load, p_grid=p_grid, cost=cost,
        temp_in_ev=x[:, lay.i_tin: lay.i_tin + H + 1],
        temp_wh_ev=x[:, lay.i_twh: lay.i_twh + H + 1],
        e_batt=x[:, lay.i_eb: lay.i_eb + H + 1] if lay.has_batt else zH1,
        temp_in1=x[:, lay.i_tin1],
        temp_wh1=x[:, lay.i_twh1],
        p_ev_ch=p_ev,
        e_ev=x[:, lay.i_eev: lay.i_eev + H + 1] if lay.has_ev else zH1,
    )
