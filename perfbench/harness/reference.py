"""The plain reference: the homes' RC dynamics, the MPC problem each home
solves, and an interior-point solver for it, in NumPy and plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's inputs (``inputs.py``) and, to judge them, the
program's outputs.  Where it needs the state a step started from, it takes
the program's previous output, which the same comparison has judged (or,
at an episode's first step, the seeded initial state); so the comparison
follows the program one step at a time.

Every function takes ``rnd``, a rounding applied to each result: the
identity in float64 for the reference, a round trip through bfloat16 for
the control (``control.py``), which computes the same in the precision
below the configuration's float32.

Units follow the reference (dragg/mpc_calc.py): R in degC/kW, C in
kJ/degC, powers in kW, a duty in raw counts of ``s`` sub-steps, dt steps
an hour.
"""

from __future__ import annotations

import numpy as np

TAP_TEMP = 15.0
WINTER_MAX_OAT = 30.0   # degC: the seasonal switch on the forecast (dragg/mpc_calc.py)
GATE_SIGMAS = 6.0       # forecast-noise deviations a gate must clear to be certain
FREE = 1.0e3            # |bound| standing for an unbounded variable
SOFT_WEIGHT = 10.0      # comfort violation penalty over the cost of heating it away
DUTY_SLACK = 1.5        # counts a first-step duty may lie from the relaxed optimum


def ident(a):
    return a


def draws_at(draws: np.ndarray, H: int, hour) -> np.ndarray:
    """Litres each home draws in sim hour ``hour`` (an int, or an int per
    home): the reference's schedule starts with H + 1 empty hours (dragg's
    ``water_draws`` prepends them), then replays the home's draws."""
    idx = np.broadcast_to(np.asarray(hour) - (H + 1), (draws.shape[0],))
    val = draws[np.arange(draws.shape[0]), np.clip(idx, 0, None)]
    return np.where(idx >= 0, val, 0.0)


def draw_window(h: dict, sel, H: int, t: int) -> np.ndarray:
    """(homes, H + 1) draw sizes the MPC sees at step ``t`` (hourly steps):
    the current hour's draw, then each later hour averaged with its
    neighbours inside the window (the last with its one neighbour)."""
    raw = np.stack([draws_at(h["draws"][sel], H, t + k) for k in range(H + 1)], axis=1)
    out = raw.copy()
    for k in range(1, H + 1):
        nb = raw[:, k - 1:k + 2]
        out[:, k] = nb.mean(axis=1)
    return out


def step(h: dict, inp: dict, prev: dict, act: dict, t: int, rp0, rnd=ident) -> dict:
    """The outputs of one step for every home, from the state it started
    in (``prev``: temp_in, temp_wh, e_batt) and the actions applied
    (``act``: duty fractions of cool, heat and the water heater, battery
    charge and discharge kW, PV curtailment, the solved flag).  A home
    whose solve failed drops its PV and idles its battery (the fallback
    controller, dragg/mpc_calc.py), and its cost is on the physical grid
    power rather than the s-scaled one."""
    s, dt = inp["s"], inp["dt"]
    idx = inp["start_index"] + t + inp["env_offset"]
    oat1 = rnd(inp["oat"][idx + 1])
    ghi0 = rnd(inp["ghi"][idx])
    price0 = rnd(inp["tou"][idx] + rp0)
    r = {k: rnd(np.asarray(v, dtype=np.float64)) for k, v in h.items()
         if k not in ("draws", "community", "local_idx", "global_idx", "type_code")}
    pv = {k: rnd(np.asarray(v, dtype=np.float64)) for k, v in prev.items()}
    a = {k: rnd(np.asarray(v, dtype=np.float64)) for k, v in act.items()}
    solved = a["solved"] > 0.5
    cool, heat, wh = rnd(a["cool"] * s), rnd(a["heat"] * s), rnd(a["wh"] * s)
    pc, ph, pw = rnd(r["p_cool"] / s), rnd(r["p_heat"] / s), rnd(r["p_wh"] / s)
    d0 = rnd(draws_at(h["draws"], inp["H"], t))
    tank = r["tank_size"]
    t_mix = rnd((pv["temp_wh"] * (tank - d0) + TAP_TEMP * d0) / tank)
    t_in = rnd(pv["temp_in"] + 3600.0 * ((oat1 - pv["temp_in"]) / r["hvac_r"]
                                       - rnd(cool * pc) + rnd(heat * ph)) / (r["hvac_c"] * dt))
    t_wh = rnd(t_mix + 3600.0 * ((t_in - t_mix) / r["wh_r"] + rnd(wh * pw))
               / (rnd(tank * 4.2) * dt))
    p_ch = np.where(solved, a["p_ch"], 0.0)
    p_d = np.where(solved, a["p_d"], 0.0)
    e = rnd(pv["e_batt"] + rnd(r["batt_ch_eff"] * p_ch / dt) + rnd(p_d / (r["batt_disch_eff"] * dt)))
    pvc = rnd(r["pv_area"] * r["pv_eff"] * ghi0 / 1000.0)
    p_pv = np.where(solved, rnd(pvc * (1.0 - a["u"])), 0.0)
    p_load = rnd(rnd(pc * cool) + rnd(ph * heat) + rnd(pw * wh))
    p_grid = rnd(p_load + p_ch + p_d - p_pv)
    cost = rnd(np.where(solved, price0 * s * p_grid, price0 * p_grid))
    return {"temp_in": t_in, "temp_wh": t_wh, "e_batt": e, "p_pv": p_pv,
            "p_load": p_load, "p_grid": p_grid, "cost": cost}


def aggregate(p_grid: np.ndarray, rnd=ident) -> float:
    """The community's load: the sum of every home's grid power (in the
    rounded type, summed in float64 as an accumulator would)."""
    return float(rnd(np.sum(rnd(p_grid), dtype=np.float64)))


# --------------------------------------------------------------- the MPC
def season(inp: dict, sel, t: int, cap: float) -> np.ndarray:
    """Per home: 1 where the heating season is certain at step ``t``, 0
    where the cooling season is, -1 where the forecast noise (standard
    deviation at most ``cap``) could tip the gate either way.  The gate is
    winter while the largest outdoor temperature of the noisy forecast
    stays at or below 30 degC."""
    H = inp["H"]
    idx = inp["start_index"] + t + inp["env_offset"][sel]
    w = inp["oat"][idx[:, None] + np.arange(H + 1)]
    hi = w.max(axis=1) + GATE_SIGMAS * cap
    lo = np.maximum(w[:, 0], w[:, 1:].max(axis=1) - GATE_SIGMAS * cap)
    return np.where(hi <= WINTER_MAX_OAT, 1, np.where(lo > WINTER_MAX_OAT, 0, -1))


class Layout:
    """Columns of one home's problem over horizon H (every home gets all
    blocks; a block a home lacks is a dummy column with no coefficient):
    cool, heat, wh, p_ch, p_d, u (H each), T_in, T_wh, e (H + 1 each),
    T_in1, T_wh1, then a slack above and one below for each soft-bounded
    state (the comfort-bound temperatures and the battery's charge).  Rows: T_in pin and dynamics, T_wh pin and dynamics, the
    one-step T_in1 and T_wh1, battery pin and dynamics."""

    def __init__(self, H: int):
        self.H = H
        c = 0
        for name, size in (("cool", H), ("heat", H), ("wh", H), ("pch", H), ("pd", H),
                           ("u", H), ("tin", H + 1), ("twh", H + 1), ("e", H + 1),
                           ("tin1", 1), ("twh1", 1)):
            setattr(self, name, c)
            c += size
        self.n_base = c
        # Soft-bounded states: T_in[1..H], T_wh[0..H], T_in1, T_wh1 (comfort)
        # and e[1..H] (the battery's charge limits).
        self.soft = np.r_[self.tin + 1 + np.arange(H), self.twh + np.arange(H + 1),
                          self.tin1, self.twh1, self.e + 1 + np.arange(H)]
        self.n = c + 2 * len(self.soft)
        self.r_tin0, self.r_tind = 0, 1
        self.r_twh0, self.r_twhd = H + 1, H + 2
        self.r_tin1, self.r_twh1 = 2 * H + 2, 2 * H + 3
        self.r_e0, self.r_ed = 2 * H + 4, 2 * H + 5
        self.m = 3 * H + 5
        self.controls0 = np.array([self.cool, self.heat, self.wh, self.pch, self.pd, self.u])


def assemble(inp: dict, sel: np.ndarray, t: int, prev: dict, rp: np.ndarray, winter: np.ndarray):
    """The MPC problem of each selected home at step ``t`` (float64
    arrays): minimise c·x subject to A x = b and l <= x <= u, where
    c prices the grid power a step, discounted, and the comfort and charge
    bounds are soft, at a penalty well above what heating or cooling a
    degree, or storing a kWh, costs.
    ``prev`` is each home's state before the step, ``rp`` (H,) or (homes,
    H) the reward price, ``winter`` the season gate.  Returns (A, b, c, l,
    u, scale): ``scale`` is the discounted cost of running the heater and
    the water heater flat out over the horizon, the unit of the gap."""
    h, H, s, dt = inp["homes"], inp["H"], inp["s"], inp["dt"]
    if dt != 1:
        raise ValueError("the reference's draw schedule is written for hourly steps")
    L = Layout(H)
    B = len(sel)
    g = {k: np.asarray(v)[sel].astype(np.float64) for k, v in h.items() if k != "draws"}
    a_in = 3600.0 / (g["hvac_c"] * dt)
    a_wh = 3600.0 / (g["tank_size"] * 4.2 * dt)
    kin, kwh, awr = 1 - a_in / g["hvac_r"], 1 - a_wh / g["wh_r"], a_wh / g["wh_r"]
    pc, ph, pw = g["p_cool"] / s, g["p_heat"] / s, g["p_wh"] / s
    idx = inp["start_index"] + t + inp["env_offset"][sel]
    win = idx[:, None] + np.arange(H + 1)
    oat, ghi = inp["oat"][win], inp["ghi"][win]
    price = inp["tou"][win[:, :H]] + np.broadcast_to(rp, (B, H))
    dsz = draw_window(h, sel, H, t)
    frac = dsz / g["tank_size"][:, None]
    t_mix = (prev["temp_wh"] * (g["tank_size"] - dsz[:, 0]) + TAP_TEMP * dsz[:, 0]) / g["tank_size"]
    batt = g["has_batt"] > 0
    pvc = (g["pv_area"] * g["pv_eff"])[:, None] * ghi[:, :H] / 1000.0

    A = np.zeros((B, L.m, L.n))
    b = np.zeros((B, L.m))
    k = np.arange(H)
    A[:, L.r_tin0, L.tin] = 1.0
    b[:, L.r_tin0] = prev["temp_in"]
    A[:, L.r_tind + k, L.tin + k + 1] = 1.0
    A[:, L.r_tind + k, L.tin + k] = -kin[:, None]
    A[:, L.r_tind + k, L.cool + k] = (a_in * pc)[:, None]
    A[:, L.r_tind + k, L.heat + k] = -(a_in * ph)[:, None]
    b[:, L.r_tind + k] = (a_in / g["hvac_r"])[:, None] * oat[:, 1:]
    A[:, L.r_twh0, L.twh] = 1.0
    b[:, L.r_twh0] = t_mix
    A[:, L.r_twhd + k, L.twh + k + 1] = 1.0
    A[:, L.r_twhd + k, L.twh + k] = -(kwh[:, None] * (1.0 - frac[:, 1:]))
    A[:, L.r_twhd + k, L.tin + k + 1] = -awr[:, None]
    A[:, L.r_twhd + k, L.wh + k] = -(a_wh * pw)[:, None]
    b[:, L.r_twhd + k] = kwh[:, None] * frac[:, 1:] * TAP_TEMP
    A[:, L.r_tin1, L.tin1] = 1.0
    A[:, L.r_tin1, L.cool] = a_in * pc
    A[:, L.r_tin1, L.heat] = -a_in * ph
    b[:, L.r_tin1] = kin * prev["temp_in"] + a_in / g["hvac_r"] * oat[:, 1]
    A[:, L.r_twh1, L.twh1] = 1.0
    A[:, L.r_twh1, L.tin + 1] = -awr
    A[:, L.r_twh1, L.wh] = -a_wh * pw
    b[:, L.r_twh1] = kwh * t_mix
    A[:, L.r_e0, L.e] = 1.0
    b[:, L.r_e0] = np.where(batt, prev["e_batt"], 0.0)
    A[:, L.r_ed + k, L.e + k + 1] = 1.0
    A[:, L.r_ed + k, L.e + k] = -1.0
    A[:, L.r_ed + k, L.pch + k] = -(np.where(batt, g["batt_ch_eff"], 0.0) / dt)[:, None]
    A[:, L.r_ed + k, L.pd + k] = -(np.where(batt, 1.0 / (g["batt_disch_eff"] * dt), 0.0))[:, None]

    lo = np.full((B, L.n), -FREE)
    hi = np.full((B, L.n), FREE)

    def box(start, size, lov, hiv):
        lo[:, start:start + size] = np.asarray(lov, dtype=float).reshape(-1, 1) if np.ndim(lov) else lov
        hi[:, start:start + size] = np.asarray(hiv, dtype=float).reshape(-1, 1) if np.ndim(hiv) else hiv

    heat_cap = np.where(winter > 0, s, 0.0)
    box(L.cool, H, 0.0, s - heat_cap)
    box(L.heat, H, 0.0, heat_cap)
    box(L.wh, H, 0.0, s)
    rate = np.where(batt, g["batt_max_rate"], 0.0)
    # A block the home lacks: a dummy column in [0, 1] with no coefficient.
    box(L.pch, H, 0.0, np.where(batt, rate, 1.0))
    box(L.pd, H, np.where(batt, -rate, 0.0), np.where(batt, 0.0, 1.0))
    box(L.u, H, 0.0, 1.0)
    box(L.tin + 1, H, g["temp_in_min"], g["temp_in_max"])
    box(L.twh, H + 1, g["temp_wh_min"], g["temp_wh_max"])
    box(L.e + 1, H, np.where(batt, g["batt_cap_min"], -1.0), np.where(batt, g["batt_cap_max"], 1.0))
    box(L.tin1, 1, g["temp_in_min"], g["temp_in_max"])
    box(L.twh1, 1, g["temp_wh_min"], g["temp_wh_max"])
    # The degenerate case of a zero-width box (a heater off for the season
    # when s - cap = 0): widen to a dummy range, its cost then zero below.
    cool_off = heat_cap >= s
    heat_off = heat_cap <= 0

    w = np.float64(inp["discount"]) ** k
    wp = w[None, :] * price
    c = np.zeros((B, L.n))
    c[:, L.cool + k] = wp * (s * pc)[:, None]
    c[:, L.heat + k] = wp * (s * ph)[:, None]
    c[:, L.wh + k] = wp * (s * pw)[:, None]
    c[:, L.pch + k] = np.where(batt[:, None], wp * s, 0.0)
    c[:, L.pd + k] = np.where(batt[:, None], wp * s, 0.0)
    c[:, L.u + k] = wp * s * pvc
    for off, col in ((cool_off, L.cool), (heat_off, L.heat)):
        A[off, :, col:col + H] = 0.0
        c[off, col:col + H] = 0.0
        hi[off, col:col + H] = 1.0

    # Soft comfort bounds: x_T = y + v_up - v_down, y boxed, v >= 0 priced.
    pmax = price.max(axis=1)
    rho_in = SOFT_WEIGHT * pmax * s / a_in
    rho_wh = SOFT_WEIGHT * pmax * s / a_wh
    nsoft = len(L.soft)
    rho_e = SOFT_WEIGHT * pmax * s
    rho = np.concatenate([np.repeat(rho_in[:, None], H, 1), np.repeat(rho_wh[:, None], H + 1, 1),
                          rho_in[:, None], rho_wh[:, None], np.repeat(rho_e[:, None], H, 1)],
                         axis=1)
    up, dn = L.n_base, L.n_base + nsoft
    A[:, :, up:up + nsoft] = A[:, :, L.soft]
    A[:, :, dn:dn + nsoft] = -A[:, :, L.soft]
    c[:, up:up + nsoft] = rho
    c[:, dn:dn + nsoft] = rho
    lo[:, up:] = 0.0
    hi[:, up:] = FREE
    scale = (wp * (s * ph + s * pw)[:, None]).sum(axis=1) * s
    return A, b, c, lo, hi, scale


def pin(A, b, c, lo, hi, cols, vals):
    """The same problems with columns ``cols`` fixed at ``vals`` (homes,
    len(cols)): their part moves to the right-hand side and their cost to
    the returned constant; the columns stay as dummies in [0, 1] with no
    coefficient, so the batch keeps its shape."""
    A, b, c, lo, hi = (a.copy() for a in (A, b, c, lo, hi))
    const = np.einsum("bk,bk->b", c[:, cols], vals)
    b -= np.einsum("bmk,bk->bm", A[:, :, cols], vals)
    A[:, :, cols] = 0.0
    c[:, cols] = 0.0
    lo[:, cols] = 0.0
    hi[:, cols] = 1.0
    return A, b, c, lo, hi, const


def ipm(A, b, c, lo, hi, device="cpu", dtype=None, rnd=None, iters=100, tol=1e-8):
    """A primal-dual interior point (Mehrotra's predictor and corrector)
    for a batch of problems min c·x, A x = b, lo <= x <= hi, on the normal
    equations by dense Cholesky.  Float64 by default; ``rnd`` rounds the
    data and every iterate (the control's bfloat16).  Returns (x, c·x,
    converged)."""
    import torch

    dtype = dtype or torch.float64
    R = rnd or (lambda v: v)
    T = lambda a: R(torch.as_tensor(np.asarray(a), dtype=dtype, device=device))  # noqa: E731
    A, b, c, lo, hi = T(A), T(b), T(c), T(lo), T(hi)
    At = A.transpose(1, 2)
    width = hi - lo
    x = torch.where(width <= 50.0, 0.5 * (lo + hi), torch.where(lo > -FREE + 1, lo + 1.0, 0.0))
    s1, s2 = x - lo, hi - x
    z1, z2 = torch.ones_like(x), torch.ones_like(x)
    y = torch.zeros_like(b)
    n2 = 2 * x.shape[1]
    tiny = torch.finfo(dtype).tiny
    eye = torch.eye(A.shape[1], dtype=dtype, device=device)
    nb = 1.0 + b.abs().amax(dim=1)
    nc = 1.0 + c.abs().amax(dim=1)

    def step_len(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
        return torch.clamp(ratio.amin(dim=1), max=1.0)

    done = torch.zeros(x.shape[0], dtype=torch.bool, device=device)
    for _ in range(iters):
        rp = b - (A @ x[..., None])[..., 0]
        rd = c - (At @ y[..., None])[..., 0] - z1 + z2
        mu = ((s1 * z1).sum(1) + (s2 * z2).sum(1)) / n2
        gap_ok = mu * n2 < tol * (1.0 + (c * x).sum(1).abs())
        done = done | ((rp.abs().amax(1) / nb < tol) & (rd.abs().amax(1) / nc < tol) & gap_ok)
        if bool(done.all()):
            break
        # A primal regularization bounds theta's inverse: a free
        # variable's barrier terms vanish and would make it unbounded.
        theta = z1 / s1 + z2 / s2 + 1e-8
        M = A @ (At / theta[..., None])
        # Jacobi scaling: the diagonal spans many decades near the end.
        d = torch.sqrt(M.diagonal(dim1=1, dim2=2))
        Ms = M / (d[:, :, None] * d[:, None, :])
        Lc, info = torch.linalg.cholesky_ex(Ms + 1e-13 * eye)
        for jitter in (1e-6, 1e-3):   # more only where rounding broke it, problem by problem
            bad = info != 0
            if not bool(bad.any()):
                break
            Lc[bad], info[bad] = torch.linalg.cholesky_ex(Ms[bad] + jitter * eye)

        def direction(t1, t2):
            g = (t1 - s1 * z1) / s1 - (t2 - s2 * z2) / s2
            rhs = rp + (A @ ((rd - g) / theta)[..., None])[..., 0]
            dy = torch.cholesky_solve((rhs / d)[..., None], Lc)[..., 0] / d
            dx = ((At @ dy[..., None])[..., 0] + g - rd) / theta
            # One pass of refinement on the primal rows, which the normal
            # equations lose first as the barrier closes.
            res = rp - (A @ dx[..., None])[..., 0]
            ddy = torch.cholesky_solve((res / d)[..., None], Lc)[..., 0] / d
            dy = dy + ddy
            dx = dx + (At @ ddy[..., None])[..., 0] / theta
            dz1 = (t1 - s1 * z1 - z1 * dx) / s1
            dz2 = (t2 - s2 * z2 + z2 * dx) / s2
            return R(dx), R(dy), R(dz1), R(dz2)

        zero = torch.zeros_like(x)
        dxa, _dya, dz1a, dz2a = direction(zero, zero)
        ap = torch.minimum(step_len(s1, dxa), step_len(s2, -dxa))
        ad = torch.minimum(step_len(z1, dz1a), step_len(z2, dz2a))
        mua = (((s1 + ap[:, None] * dxa) * (z1 + ad[:, None] * dz1a)).sum(1)
               + ((s2 - ap[:, None] * dxa) * (z2 + ad[:, None] * dz2a)).sum(1)) / n2
        sigma = torch.clamp(mua / mu, 0.0, 1.0) ** 3
        t1 = (sigma * mu)[:, None] - dxa * dz1a
        t2 = (sigma * mu)[:, None] + dxa * dz2a
        dx, dy, dz1, dz2 = direction(t1, t2)
        ap = 0.99 * torch.minimum(step_len(s1, dx), step_len(s2, -dx))
        ad = 0.99 * torch.minimum(step_len(z1, dz1), step_len(z2, dz2))
        live = (~done).to(dtype)[:, None]
        x = R(x + live * ap[:, None] * dx)
        # The slacks move with x rather than being recomputed from it:
        # x - lo loses its digits when x sits on a bound far from zero.
        s1 = R(torch.clamp(s1 + live * ap[:, None] * dx, min=tiny))
        s2 = R(torch.clamp(s2 - live * ap[:, None] * dx, min=tiny))
        y = R(y + live * ad[:, None] * dy)
        z1 = R(z1 + live * ad[:, None] * dz1)
        z2 = R(z2 + live * ad[:, None] * dz2)
    obj = (c * x).sum(1)
    return x.double().cpu().numpy(), obj.double().cpu().numpy(), done.cpu().numpy()


def mpc_gap(inp: dict, sel, t_of: np.ndarray, prev: dict, act: dict, rp, cap: float,
            device="cpu", solve_rnd=None, solve_dtype=None) -> dict:
    """Per sampled home-step: the relative cost of the applied first
    action.  The reference solves each home's problem (J*) and the same
    problem with the first step's battery and PV controls fixed at
    ``act`` and its duties boxed to within ``DUTY_SLACK`` counts of
    ``act``'s (J_pin); the gap is (J_pin - J*) / scale, zero for a first
    action that an optimal one rounds to, infinite for one outside its
    bounds or missing.

    With ``solve_rnd`` the actions come from the reference's own solve in
    that rounding (the control) instead of from ``act``, clamped into their
    bounds as the program's integer pin clamps its own; a control action
    that is not a number stays outside.  Home-steps whose
    season the forecast noise could tip are left out (``skipped``)."""
    sel = np.asarray(sel)
    out = {"gap": np.full(len(sel), np.nan), "skipped": 0, "unconverged": 0}
    groups = {}
    for j, (i, t) in enumerate(zip(sel, t_of)):
        groups.setdefault(int(t), []).append(j)
    problems, pins, meta = [], [], []
    for t, js in sorted(groups.items()):
        js = np.array(js)
        hs = sel[js]
        win = season(inp, hs, t, cap)
        ok = win >= 0
        out["skipped"] += int((~ok).sum())
        js, hs = js[ok], hs[ok]
        if not len(js):
            continue
        pj = {k: np.asarray(v)[js] for k, v in prev.items()}
        rpj = rp[js] if np.ndim(rp) == 2 else rp
        A, b, c, lo, hi, scale = assemble(inp, hs, t, pj, rpj, win[ok])
        problems.append((A, b, c, lo, hi))
        meta.append((js, scale))
        pins.append({k: np.asarray(v)[js] for k, v in act.items()})
    if not problems:
        return out
    cat = [np.concatenate(p) for p in zip(*problems)]
    js = np.concatenate([m[0] for m in meta])
    scale = np.concatenate([m[1] for m in meta])
    act_all = {k: np.concatenate([p[k] for p in pins]) for k in pins[0]}
    L = Layout(inp["H"])
    x_star, j_star, ok_star = ipm(*cat, device=device)
    if solve_rnd is not None:
        x_c, _, _ = ipm(*cat, device=device, rnd=solve_rnd, dtype=solve_dtype)
        vals = np.clip(x_c[:, L.controls0], cat[3][:, L.controls0], cat[4][:, L.controls0])
    else:
        s = inp["s"]
        vals = np.stack([act_all["cool"] * s, act_all["heat"] * s, act_all["wh"] * s,
                         act_all["p_ch"], act_all["p_d"], act_all["u"]], axis=1)
    A, b, c, lo, hi = cat
    # The first step's duties may sit up to DUTY_SLACK counts from the
    # relaxed optimum (rounded to whole counts, then one count towards
    # comfort: the configuration's integer first action), so they are
    # boxed to that reach; the continuous controls are fixed.
    duty, cont = L.controls0[:3], L.controls0[3:]
    lo2, hi2 = lo.copy(), hi.copy()
    lo2[:, duty] = np.maximum(lo[:, duty], vals[:, :3] - DUTY_SLACK)
    hi2[:, duty] = np.minimum(hi[:, duty], vals[:, :3] + DUTY_SLACK)
    cols = L.controls0
    tol = 1e-3 * (1.0 + np.abs(vals))
    outside = ((vals < lo[:, cols] - tol).any(1) | (vals > hi[:, cols] + tol).any(1)
               | ~np.isfinite(vals).all(1))
    lo2[outside], hi2[outside] = lo[outside], hi[outside]
    pa = pin(A, b, c, lo2, hi2, cont, np.where(np.isfinite(vals[:, 3:]), vals[:, 3:], 0.0))
    _, j_pin, ok_pin = ipm(*pa[:5], device=device)
    gap = (j_pin + pa[5] - j_star) / scale
    # An action outside its box, or no action at all, is no answer.
    gap = np.where(outside, np.inf, gap)
    out["gap"][js] = gap
    out["outside"] = int(outside.sum())
    out["unconverged"] = int((~ok_star).sum() + (~ok_pin[~outside]).sum())
    return out
