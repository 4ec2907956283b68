"""``tests/test_torch_dryrun.py``'s tests of the dryrun's parts on a gloo
group of 4 subprocess ranks against JAX's calls on a 4-device mesh (the
tournament ICP on a (2, 2) mesh, the rest on (4, 1) or (1, 4)); the
pipeline runs on ranks 0 and 1 and ranks 2 and 3 only make its group.
The same tolerances; a file of its own so that each file stays within
its share of the test run."""

import pytest

from test_torch_dryrun import (  # noqa: F401
    both,
    test_ba_part_matches_jax,
    test_fusion_parts_match_jax,
    test_icp_parts_match_jax,
    test_pipeline_part_matches_scanned_driver_and_jax,
    test_replicated_outputs_are_identical_across_ranks,
    test_warp_part_matches_jax,
)


@pytest.fixture(scope="module")
def world():
    return 4
