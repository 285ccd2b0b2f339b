"""Does a home's solve on the GPU depend on the batch it is solved in?

    python -m dragg_tpu_torch.fleet_witness [--homes 2500] [--communities 4]
                                            [--community 3] [--steps 24]

The fleet of ``chip_smoke.py`` phase 13 (``--communities`` communities of
``--homes`` homes under the stress_dr_outage pack, ``tpu.fix_tou_peak``,
24 h of weather apart, H = 24, the interior point's split route without
tail compaction) and community ``--community`` of it run on the card in
three engines, each one chunk of ``--steps`` hourly steps from t = 0:

* alone: the community by itself (``communities = 1``,
  ``community_base = --community``), at its own bucket batch sizes;
* replica: ``--communities`` copies of that community in one engine, the
  fleet's bucket batch sizes, every row the same QP as the run alone;
* fleet: the distinct communities, as phase 13 runs them.

Each copy of the replica and the community within the fleet are held
against the run alone home by home with ``compare_homes`` (phase 13's
statistic), and the replica's copies against its first.  If the copies
part from the run alone as far as the fleet's community does, the
fleet's difference is the batch's, not the fleet's wiring; the fleet's
community against the replica's copy at the same rows, bit for bit.
Then the mechanism: ``torch.sum`` over the last axis of a float32 (B, n)
array on the card against the same rows stored 1 to 4 rows further on,
bit-equal or not, at each bucket's (B, n).

Prints one JSON object; the same goes to ``chiprun_out/fleet_witness.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

# Applied duty counts further apart than this are a flip: a home whose
# integer pin failed applies its relaxed (fractional) counts, which two
# solves within the interior point's 2e-4 tolerance leave up to ~1e-3
# counts apart, enough to move a temperature by 1e-3 degC.
FLIP_COUNTS = 1e-4
DUTY = ("hvac_cool_on", "hvac_heat_on", "wh_heat_on")
BATTERY_SERIES = ("e_batt", "p_batt_ch", "p_batt_disch")
SERIES = ("cost", "temp_in", "temp_wh", *BATTERY_SERIES)


def compare_homes(ref: dict, cmp: dict, s: float, battery, storage, tols=None) -> dict:
    """``cmp`` against ``ref``, dicts of (steps, homes) arrays in one home
    order (``correct_solve``, the duty fractions of DUTY, SERIES), ``s``
    the duty steps, ``battery`` and ``storage`` (battery or EV) (homes,)
    masks.  A home is compared on its steps before its first flip: a
    solved flag that differs, or applied duty counts more than
    FLIP_COUNTS apart (either sends its state down another path).
    ``tols`` maps a series (``"cost"`` for the homes without storage,
    ``"cost (storage homes)"``) to ``(rtol, atol)``; the result lists the
    homes beyond them."""
    tols = tols or {}
    battery, storage = np.asarray(battery, bool), np.asarray(storage, bool)
    steps, homes = np.shape(ref["correct_solve"])
    ok_r, ok_c = np.asarray(ref["correct_solve"]) > 0, np.asarray(cmp["correct_solve"]) > 0
    counts = np.max([np.abs(np.asarray(cmp[k]) - np.asarray(ref[k])) * s for k in DUTY], axis=0)
    flip = (ok_r != ok_c) | (counts > FLIP_COUNTS)
    first = np.where(flip.any(axis=0), np.argmax(flip, axis=0), steps)
    before = np.arange(steps)[:, None] < first[None, :]
    flipped = first < steps
    at_first = np.clip(first, 0, steps - 1), np.arange(homes)
    solved_flip = flipped & (ok_r[at_first] != ok_c[at_first])
    worst, bad = {"duty_counts": float(np.max(counts[before], initial=0.0))}, []
    for key in SERIES:
        a, b = np.asarray(ref[key], np.float64), np.asarray(cmp[key], np.float64)
        d = np.abs(b - a)
        groups = ((f"{key} (storage homes)", storage), (key, ~storage)) if key == "cost" \
            else ((key, battery),) if key in BATTERY_SERIES \
            else ((key, np.ones(homes, bool)),)
        for name, homes_in in groups:
            sel = before & homes_in[None, :]
            worst[name] = float(np.max(d[sel], initial=0.0))
            if name in tols:
                rtol, atol = tols[name]
                over = sel & (d > atol + rtol * np.abs(a))
                bad += [f"home {h}: {name} differs by {float(np.max(d[:, h][over[:, h]]))} "
                        f"before its first flip" for h in np.unique(np.argwhere(over)[:, 1])]
    return dict(homes=int(homes), steps=int(steps),
                solved_flag_agreement=float(np.mean(ok_r == ok_c)),
                compared_share=float(before.mean()),
                homes_first_flip_solved=int(solved_flip.sum()),
                homes_first_flip_rounding=int((flipped & ~solved_flip).sum()),
                first_step_max_abs_differences={
                    k: float(np.max(np.abs(np.asarray(cmp[k])[0] - np.asarray(ref[k])[0])))
                    for k in (*SERIES, *DUTY)},
                max_abs_differences_before_flip=worst, violations=bad[:10])


def engine_series(eng, steps: int) -> dict:
    """One chunk of ``steps`` steps from t = 0 (the reward price zero):
    the per-home outputs as (steps, homes) float64 in the community-major
    order (``real_home_cols``), and the run's seconds."""
    import torch

    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    rps = np.zeros((steps, eng.params.horizon), np.float32)
    sync()
    t0 = time.perf_counter()
    _, out = eng.run_chunk(eng.init_state(), 0, rps)
    sync()
    secs = time.perf_counter() - t0
    cols = eng.real_home_cols
    return {k: getattr(out, k).cpu().double().numpy()[:, cols]
            for k in ("correct_solve", *DUTY, *SERIES)}, secs


def replica_engine(alone, copies: int):
    """``copies`` copies of the community of the aggregator ``alone`` in
    one engine: its homes, seed, weather offset and events on every copy,
    the batch type-major as a fleet's."""
    from dragg_tpu_torch.engine import make_engine
    from dragg_tpu_torch.homes import (TYPE_CODES, FleetSpec, build_home_batch,
                                       type_bucket_ranges)

    homes, spec = alone.all_homes, alone.engine.fleet
    B = len(homes)
    ranges = type_bucket_ranges(np.asarray([TYPE_CODES[h["type"]] for h in homes]))
    order = np.concatenate([np.arange(c * B + a, c * B + b)
                            for (_t, a, b) in ranges for c in range(copies)])
    fleet = FleetSpec(n_communities=copies, homes_per_community=B, seeds=spec.seeds * copies,
                      community=(order // B).astype(np.int32), global_idx=order.astype(np.int32),
                      local_idx=(order % B).astype(np.int32),
                      env_offset=np.full(len(order), spec.env_offset[0], np.int32))
    hems = alone.config["home"]["hems"]
    horizon = int(hems["prediction_horizon"]) * alone.dt
    batch = build_home_batch([homes[i % B] for i in order], horizon, alone.dt,
                             int(hems["sub_subhourly_steps"]))
    return make_engine(batch, alone.env, alone.config, alone.start_index,
                       device=alone.engine.device, fleet=fleet, data_dir=alone.data_dir)


def sum_order(shapes, device: str = "cuda") -> list:
    """``torch.sum`` over the last axis of a float32 (B, n) array on the
    card against the sums of the same rows stored ``shift`` rows further
    into a larger array (shift 1 to 4: the rows' addresses move by
    ``shift * n * 4`` bytes), at each (name, B, n)."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    out = []
    for name, B, n in shapes:
        x = torch.rand((B, n), generator=g, device=device) - 0.5
        one = x.sum(dim=1)
        for shift in (1, 2, 3, 4):
            y = torch.zeros((B + shift, n), device=device)
            y[shift:] = x
            moved = y[shift:].sum(dim=1)
            out.append(dict(bucket=name, B=B, n=n, shift_rows=shift,
                            bit_equal=bool(torch.equal(one, moved)),
                            rows_differing=int((one != moved).sum()),
                            max_abs_difference=float((one - moved).abs().max())))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch.fleet_witness")
    p.add_argument("--homes", type=int, default=2_500)
    p.add_argument("--communities", type=int, default=4)
    p.add_argument("--community", type=int, default=3)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--device", default="cuda", help="cpu: a dry run at a small size")
    args = p.parse_args(argv)

    import torch

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import pack_fleet_config

    C, k = args.communities, args.community

    def built(communities: int, base: int):
        cfg = pack_fleet_config(args.homes, 24, args.steps, communities, ipm_tail_frac=0.0)
        cfg["fleet"]["community_base"] = base
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(cfg, outputs_dir=d, device=args.device)
            agg.get_homes()
            agg._build_engine()
        return agg

    alone = built(1, k)
    fleet = built(C, 0)
    s = float(alone.config["home"]["hems"]["sub_subhourly_steps"])
    battery = np.array(["battery" in h["type"] for h in alone.all_homes])
    storage = battery | np.array([h["type"] == "ev" for h in alone.all_homes])
    ref, t_alone = engine_series(alone.engine, args.steps)
    rep, t_rep = engine_series(replica_engine(alone, C), args.steps)
    fl, t_fleet = engine_series(fleet.engine, args.steps)
    B = args.homes
    part = lambda d, c: {key: v[:, c * B:(c + 1) * B] for key, v in d.items()}  # noqa: E731
    names = [h["name"] for h in alone.all_homes]
    assert names == [h["name"] for h in fleet.all_homes[k * B:(k + 1) * B]]
    result = dict(
        card=torch.cuda.get_device_name(0) if args.device == "cuda" else args.device, homes=B, communities=C, community=k,
        steps=args.steps,
        buckets_alone=[[b["name"], b["n_real"], b["n_var"]] for b in alone.engine.bucket_info()],
        buckets_fleet=[[b["name"], b["n_real"], b["n_var"]] for b in fleet.engine.bucket_info()],
        run_s=dict(alone=t_alone, replica=t_rep, fleet=t_fleet),
        replica_copies_vs_alone=[compare_homes(ref, part(rep, c), s, battery, storage)
                                 for c in range(C)],
        replica_copies_vs_copy_0=[compare_homes(part(rep, 0), part(rep, c), s, battery, storage)
                                  for c in range(1, C)],
        fleet_community_vs_alone=compare_homes(ref, part(fl, k), s, battery, storage),
        fleet_community_equals_replica_copy={
            key: bool(np.array_equal(part(fl, k)[key], part(rep, k)[key])) for key in fl},
        sum_order=sum_order([(b["name"], b["n_real"], b["n_var"])
                             for b in alone.engine.bucket_info()], args.device),
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "fleet_witness.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
