"""Graph compiler: IR, the ONNX-subset importer (optional ``onnx``),
passes, lowering to a Program, its executor, and the on-disk Program
artifacts (compile once, warm-boot from disk)."""

from repro_torch.compiler.artifact import (ArtifactError, ArtifactStore,
                                           array_digest, load_program,
                                           recipe_digest, save_program)
from repro_torch.compiler.ir import (Graph, GraphError, Node,
                                     UnsupportedOpError, graph_from_dict,
                                     graph_from_json, graph_to_dict,
                                     graph_to_json)
from repro_torch.compiler.lower import (Program, Step, compile_graph,
                                        program_from_numpy)
from repro_torch.compiler.onnx_import import (HAS_ONNX, SUPPORTED_ONNX_OPS,
                                              import_onnx)
from repro_torch.compiler.passes import (annotate_precision, eliminate_dead,
                                         fold_constants, fuse_epilogues,
                                         infer_shapes, run_pipeline)

__all__ = ["Graph", "Node", "GraphError", "UnsupportedOpError",
           "graph_from_dict", "graph_to_dict", "graph_from_json",
           "graph_to_json", "Program", "Step", "compile_graph",
           "program_from_numpy", "ArtifactError", "ArtifactStore",
           "array_digest", "save_program", "load_program", "recipe_digest",
           "HAS_ONNX", "import_onnx", "SUPPORTED_ONNX_OPS", "infer_shapes",
           "fold_constants", "fuse_epilogues", "annotate_precision",
           "eliminate_dead", "run_pipeline"]
