"""Device-mesh parallelism of the port: SPMD over ``torch.distributed``,
one rank per device (``parallel/mesh.py``).

Axis conventions, as in the JAX package: ``dp`` data parallel, ``fsdp``
parameter sharding within data parallel, ``tp`` tensor parallel (Megatron
column/row splits), ``sp`` sequence parallel (ring attention or Ulysses),
``ep`` expert parallel, ``pp`` pipeline parallel (the GPipe schedule over
point-to-point exchanges, ``parallel/pipeline.py``). The port serves over
``tp``, ``sp`` and ``ep`` (``dp`` as replicas, ``models/replicated.py``)
and trains over ``dp``, ``fsdp``, ``tp``, ``sp`` and ``ep``, and through
the pipeline over ``pp`` (``models/transformer.py::forward_pipelined``).
"""

from bee_code_interpreter_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    auto_mesh,
    initialize_distributed,
    local_device_count,
    make_mesh,
    mesh_descriptor,
    mesh_shape_key,
    spawn,
)
from bee_code_interpreter_tpu_torch.parallel.pipeline import (  # noqa: F401
    spmd_pipeline,
)
from bee_code_interpreter_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_attention_sharded,
)
from bee_code_interpreter_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_attention_sharded,
)
