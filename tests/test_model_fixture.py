"""Golden-output test on the bundled reference fixture (measured ground
truth, SURVEY.md §4: `0.1.3.4.-6.` / `0.1.3.5.-6.` at k=4)."""

import shutil
import tempfile
from pathlib import Path

import pytest

from dbgtpu.pipeline import run_pipeline

DATA = Path(__file__).with_name("data")
FIXTURE_READS = DATA / "reads.fa"
FIXTURE_UNITIGS = DATA / "unitig.fa"

GOLDEN_PATHS = b">nomiss\n0.1.3.4.-6.\n>nomiss\n0.1.3.5.-6.\n"


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    td = tmp_path_factory.mktemp("fixture")
    shutil.copy(FIXTURE_READS, td / "reads.fa")
    shutil.copy(FIXTURE_UNITIGS, td / "unitig.fa")
    return td


def test_fixture_golden_python(fixture_files):
    paths, na, stats = run_pipeline(
        [str(fixture_files / "reads.fa")],
        str(fixture_files / "unitig.fa"),
        k=4, m=2, effort=2, impl="python",
    )
    assert paths == GOLDEN_PATHS
    assert na == b""
    assert stats.read_number == 2
    assert stats.aligned == 2


def test_fixture_vs_live_oracle(fixture_files):
    from . import oracle

    if not oracle.reference_available():
        pytest.skip("reference not mounted")
    ref_paths, ref_na, _ = oracle.run_reference(
        FIXTURE_READS.read_bytes(), FIXTURE_UNITIGS.read_bytes(), k=4
    )
    paths, na, _ = run_pipeline(
        [str(fixture_files / "reads.fa")],
        str(fixture_files / "unitig.fa"),
        k=4, m=2, effort=2, impl="python",
    )
    assert paths == ref_paths
    assert na == ref_na
