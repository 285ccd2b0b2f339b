"""Output-directory layout (a copy of ``dragg_tpu/utils/layout.py``) — the single source of truth for the run-folder
names shared by the writer (Aggregator.set_run_dir) and discovery
(Reformat.set_date_folders/set_mpc_folders).

Format parity with the reference layout (dragg/aggregator.py:818-829,
discovered back at dragg/reformat.py:101-142):
``outputs/<start>_<end>/<type>-homes_<N>-horizon_<H>-interval_<X>-<Y>-solver_<S>/version-<V>``.
"""

from __future__ import annotations

from datetime import datetime


def date_folder_name(start_dt: datetime, end_dt: datetime) -> str:
    return f"{start_dt.strftime('%Y-%m-%dT%H')}_{end_dt.strftime('%Y-%m-%dT%H')}"


def run_dir_name(check_type: str, n_homes: int, horizon_hours: int,
                 agg_subhourly_steps: int, sub_subhourly_steps: int,
                 solver: str) -> str:
    dt_interval = 60 // int(agg_subhourly_steps)
    return (
        f"{check_type}-homes_{n_homes}"
        f"-horizon_{horizon_hours}"
        f"-interval_{dt_interval}-{dt_interval // int(sub_subhourly_steps)}"
        f"-solver_{solver}"
    )
