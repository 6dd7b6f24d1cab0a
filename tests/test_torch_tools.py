"""The port's measuring tools: the parts that run without a card."""
import dataclasses

import pytest

from fast_lio_tpu_torch.tools import profile_scan
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),  # overlap, out of order
    ([(0.0, 4.0), (1.0, 2.0), (4.0, 5.0)], 5.0),  # nested, touching
])
def test_busy_time_is_the_union_of_intervals(intervals, busy):
    assert profile_scan._busy_us(intervals) == busy


def test_rejects_unknown_presets():
    with pytest.raises(SystemExit):
        profile_scan.main(["no_such_preset"])


def test_profile_runs_include_the_grouped_backend():
    grouped, base = (profile_scan.RUNS[n][0]
                     for n in ("ouster64_grouped", "ouster64"))
    assert grouped == dataclasses.replace(base, knn_backend="grouped")

