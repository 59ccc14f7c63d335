"""repro_torch: HummingBird private inference in PyTorch with CUDA kernels
for Hopper, a port of the JAX package ``repro`` (which stays the reference).

Same layout as the reference, so each module names its twin:

  core/     ring (Z/2^64 as int64), prng (jax-identical threefry), fixed,
            shares, comm, beaver, gmw (round-fused engine), gmw_ref (the
            frozen seed protocol, the oracle), ring_linalg, mpc_tensor,
            plus the copied schedule/hummingbird/costmodel
  kernels/  CUDA kernels (``csrc/``) behind ``ops`` wrappers, their plain
            PyTorch versions (``ref``) and the build (``build``)
  api/      Plan, Session, compile -> PrivateModel
  nn/       the dense LM's projections and RoPE (its public tables bit for
            bit the reference's: ``rope_tables``), and the reduced-ring
            lowering of its nonlinearities (``nn/approx``)
  models/   ResNet (plaintext forward + registered MPC forward) and the
            dense LM (plaintext twin + registered MPC forward)
  configs/  ResNet configs and the LM architectures
  search/   the paper's offline phase: MPC simulator, HummingBird-eco and
            -b, the STE finetune (over ``data/`` ImagePipeline and
            ``train/`` SGD)
  serve/    request-level serving: ``InferenceEngine`` (admission,
            ``BatchPolicy``, tenants, the pump), the HTTP ``Frontend`` and
            the leader's deployment CLI
  transport/ the two-process deployment: ``SocketComm`` (the reference's
            HBTP over TCP, a local party dimension of 1), job bundles, the
            engine link; ``launch/party_host`` runs one party; faults,
            ``ResilientComm`` and round journals in ``core/``, persisted by
            ``checkpoint/``
  runtime/  the round-loop choice and the straggler watchdog

Entry points run on the GPU unless given ``device="cpu"``: ``device=None``
means CUDA and raises without a card (``device.resolve``).
"""
