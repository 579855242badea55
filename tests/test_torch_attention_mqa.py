"""The port's plain ragged attention against the interpret-mode Pallas
kernel with a single kv head (MQA), the case of the kernel's own
test_pallas_mqa_and_group1. Its own file: the Pallas kernel's interpret
compile for this head layout alone takes most of a file's time budget."""

from test_torch_attention import _ragged_case, check_ragged_case


def test_plain_ragged_matches_pallas_mqa():
    check_ragged_case(_ragged_case(spans=[(6, 6), (1, 12)], Hk=1, H=4, seed=2))
