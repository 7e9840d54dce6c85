"""JAX-native multi-modal similarity (MMS) answer-selection framework.

A from-scratch JAX/XLA/Pallas rebuild of the capability set of the
``lxmeng/mms_answer_selection`` Caffe fork (reference layout documented in
SURVEY.md).  Nothing here is a port of Caffe: tensors are JAX arrays, the
graph runtime is ``jax.jit``, multi-device execution is a
``jax.sharding.Mesh``, and learned-metric retrieval scores a query against
every candidate with fused Pallas MaxSim kernels (Triton on the GPU).

Subpackages
-----------
ops        similarity / conv / pooling / batch-norm / embedding / loss ops
metrics    IR metric suite (MAP / MRR / AUC / RankAccuracy, trec_eval parity)
models     the MMS model family (network_v3/v4/v4_2/v5, pair-image metric)
data       TREC-QA / WikiQA data pipeline (XML -> packed arrays)
training   AdaDelta & friends, LR policies, train loop, checkpointing
parallel   device-mesh sharding (data/model parallel train + eval steps)
serve      query engine: sharded candidate scoring + on-chip top-k
utils      fillers, configs, timers
"""

__version__ = "0.1.0"
