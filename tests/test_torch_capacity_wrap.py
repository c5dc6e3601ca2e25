"""The `log_wrap` case of tests/test_torch_capacity.py, whose docstring
says what is held, in a file of its own: one reference compile per file."""

from test_torch_capacity import (pytest_generate_tests, runs,  # noqa: F401
                                 test_frame_flags_equal, test_log_ids_and_spill_equal,
                                 test_spill_remap_equal, test_trajectory_within_tolerance)

CASE_NAMES = ("log_wrap",)
