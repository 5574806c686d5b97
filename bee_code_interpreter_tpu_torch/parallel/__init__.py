"""Device-mesh parallelism of the port: SPMD over ``torch.distributed``,
one rank per device (``parallel/mesh.py``).

Axis conventions, as in the JAX package: ``dp`` data parallel, ``fsdp``
parameter sharding within data parallel, ``tp`` tensor parallel (Megatron
column/row splits), ``sp`` sequence parallel, ``ep`` expert parallel. The
port serves over ``tp``; ring attention, Ulysses and the pipeline are not
ported yet (ROADMAP Queue 1, item 4).
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
