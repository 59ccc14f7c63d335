"""One smoke-width block of the private LM at S = 128 against the
reference, bit for bit: the length where RoPE tables built with float32
torch cos/sin first flipped an encoded LSB of the output shares (the
port now builds them as XLA does, ``nn/rope_tables.py``).  Its own file,
so the reference's long run (about a minute) goes to its own worker."""
import numpy as np

from repro_torch.core import comm as tcomm, ring as tring
from test_torch_lm import _Setup


def test_one_block_long_sequence_bit_identical():
    """Exact plan, 1 stream: input and output shares and the counters equal
    the reference's."""
    setup = _Setup(n_layers=1, streams=1, seq=128)
    ref_in, ref_out, ref_rounds, ref_bytes = setup.ref_run(None)
    cc = tcomm.CoalescingComm(tcomm.CountingComm())
    xs, outs, _ = setup.port_run(None, cc)
    np.testing.assert_array_equal(tring.to_uint64_np(xs[0].data), ref_in[0])
    np.testing.assert_array_equal(tring.to_uint64_np(outs[0].data), ref_out[0])
    assert (cc.n_rounds, cc.bytes_tx) == (ref_rounds, ref_bytes)
