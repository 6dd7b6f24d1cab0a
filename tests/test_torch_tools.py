"""The port's measuring tool: the parts that run without a card."""
import pytest

from fast_lio_tpu_torch.tools import profile_scan


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
