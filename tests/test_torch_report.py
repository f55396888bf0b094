"""The port's copies of the JAX package's jax-free report and logging
helpers (``utils/report.py``, ``utils/logs.py``), held against the
originals."""

import dataclasses
import logging

import numpy as np
import pytest

from mpi_knn_tpu.utils import logs as jax_logs
from mpi_knn_tpu.utils import report as jax_report
from mpi_knn_tpu_torch.utils import logs, report


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recall_at_k_matches_jax(seed):
    rng = np.random.default_rng(seed)
    want = rng.integers(-1, 50, (5000, 10)).astype(np.int32)
    got = np.where(rng.random((5000, 10)) < 0.8, want,
                   rng.integers(0, 50, (5000, 10))).astype(np.int32)
    assert report.recall_at_k(got, want) == jax_report.recall_at_k(got, want)
    assert report.recall_at_k(got[:0], want[:0]) == 1.0


def test_run_report_has_the_jax_fields():
    ours = {f.name for f in dataclasses.fields(report.RunReport)}
    theirs = {f.name for f in dataclasses.fields(jax_report.RunReport)}
    assert ours == theirs
    rep = report.RunReport(config={"k": 3}, data_source="synthetic",
                           shape=(8, 4), matches=7, total=8)
    doc = rep.finalize()
    assert set(doc) == theirs | {"environment"}
    assert doc["environment"]["platform"] in ("cpu", "gpu")
    assert '"matches": 7' in rep.to_json()


@pytest.mark.parametrize("verbosity,quiet,level", [
    (0, False, logging.WARNING), (1, False, logging.INFO),
    (2, False, logging.DEBUG), (2, True, logging.ERROR)])
def test_setup_logging_levels_match_jax(verbosity, quiet, level, capsys):
    log = logs.setup_logging(verbosity, quiet)
    assert log.level == level == jax_logs.setup_logging(verbosity, quiet).level
    assert len(log.handlers) == 1 and not log.propagate
    log.error("boom")
    assert "[rank0/1] mpi_knn_tpu_torch ERROR: boom" in capsys.readouterr().err
