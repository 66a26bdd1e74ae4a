"""The control of ``yi-9b.long_prompt`` comes out not correct where the
program's own runs keep its limit (``bench_smoke.control_case``, which
finds the cell by this file's name). A file a cell, so that each cell's
control runs on a worker of its own."""
from __future__ import annotations

import bench_smoke


def test_control_fails_the_limit_that_the_program_keeps(tmp_path,
                                                       monkeypatch):
    bench_smoke.control_case(tmp_path, __file__, monkeypatch)
