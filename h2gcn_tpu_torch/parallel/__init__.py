"""Host-parallel work of the port. So far the row-sharded exact-hop
precompute (:mod:`h2gcn_tpu_torch.parallel.spgemm`); the device-distributed
layer of the JAX package's ``parallel/`` is not ported yet (ROADMAP A9).
Importing this package imports nothing else: the spgemm's spawned workers
import it, and stay off torch."""
