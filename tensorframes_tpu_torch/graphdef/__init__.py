"""GraphDef import: run frozen TF models as PyTorch programs — no TensorFlow dep.

Port of ``tensorframes_tpu/graphdef``.  The reference ships a serialized
``GraphDef`` to the runtime (``TensorFlowOps.scala:101-141``; the
frozen-model scoring flow ``read_image.py:108-167`` is benchmark configs
3 and 4).  Here GraphDef is an interchange format only: a pure-python
protobuf codec (``wire.py``/``proto.py``) parses the graph, and
``importer.py`` lowers the node graph onto torch ops (the ``ops.py``
registry), producing the same :class:`~tensorframes_tpu_torch.program.Program`
every verb consumes.
"""

from .importer import GraphImportError, import_graphdef, load_graphdef, placeholder_specs
from .proto import AttrValue, GraphDef, NodeDef, TensorProto, parse_graphdef

__all__ = [
    "import_graphdef",
    "load_graphdef",
    "parse_graphdef",
    "placeholder_specs",
    "GraphImportError",
    "GraphDef",
    "NodeDef",
    "AttrValue",
    "TensorProto",
]
