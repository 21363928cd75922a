"""Federated rounds over the parameter server (``ewdml_tpu/federated``).

Instead of a fixed pool of W workers, the server samples a cohort of
``--cohort`` clients a round from a registered pool (``--pool-size``);
each sampled client runs ``--local-steps`` of local SGD from the pulled
weights on its own non-IID shard (``data/partition.py``) and pushes the
weight delta as a pseudo-gradient through the compressor into the server's
apply. Under ``--server-agg homomorphic`` the server's cost a round is one
dequantize whatever the cohort, and the int32 accumulator's budget bounds
the cohort (``core.config.federated_max_cohort``).

- :mod:`~ewdml_tpu_torch.federated.sampler`: seeded, replayable draws;
- :mod:`~ewdml_tpu_torch.federated.ledger`: the round journal;
- :mod:`~ewdml_tpu_torch.federated.coordinator`: the server-side round
  state and the cohort policy;
- :mod:`~ewdml_tpu_torch.federated.client`: the client pool;
- :mod:`~ewdml_tpu_torch.federated.loop`: the round driver, in process
  or over TCP (``NetTransport``, ``ps_net --role fed_driver``);
- :mod:`~ewdml_tpu_torch.federated.pipeline`: the pipelined drivers of
  ``--round-pipeline overlap|async``.
"""

from ewdml_tpu_torch.core.config import federated_max_cohort  # noqa: F401
from ewdml_tpu_torch.federated.coordinator import FederatedCoordinator  # noqa: F401
from ewdml_tpu_torch.federated.ledger import (RoundLedger,  # noqa: F401
                                              read_ledger, round_sequence)
from ewdml_tpu_torch.federated.loop import (FedRunResult,  # noqa: F401
                                            InProcessTransport,
                                            NetTransport, run_federated)
from ewdml_tpu_torch.federated.sampler import CohortSampler  # noqa: F401
