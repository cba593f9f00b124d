"""ceph_tpu_torch: the PyTorch/CUDA port of ceph_tpu's erasure-coding path
and CRUSH bulk placement.

A package of its own beside ``ceph_tpu`` (the JAX reference): it imports
``torch`` and numpy, never ``jax`` and nothing of ``ceph_tpu``; what it
needs from the reference's host modules it keeps as its own copies.

Subpackages:
  gf        GF(2^8) tables and RS matrix algebra, GF(2) bitmatrix codes,
            GF(2^16)/GF(2^32) fields (host, numpy)
  ops       the hand-written CUDA kernels (csrc/), their plain PyTorch
            versions, and RSCodec
  plugins   ErasureCodeInterface / registry with the ``torch_rs``,
            ``jerasure``, ``isa`` and ``shec`` plugins
  backend   ECUtil stripe layer: encode/decode over many stripes, HashInfo
  bench     ceph_erasure_code_benchmark-compatible CLI
  crush     CrushMap, the rjenkins hash and crush_ln, the exact host rule
            interpreter, the text compiler, and BulkMapper over the
            straw2 kernel (ops/csrc/crush_straw2.cu)
  osdmap    OSDMap, Incremental, the scalar PG mapping chain and
            BulkPGMapper (whole pools in one kernel launch)
  mgr       the balancer: osd_deviation, calc_weight_set, calc_pg_upmaps
  tools     osdmaptool and crushtool CLIs, the kernel sweep and the
            measurement tools

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``"cpu"`` (the plain PyTorch versions) or ``"numpy"`` (the host
reference codec).
"""
__version__ = "0.1.0"
