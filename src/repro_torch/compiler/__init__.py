"""Graph compiler: IR, passes, lowering to a Program, its executor, and
the on-disk Program artifacts (compile once, warm-boot from disk)."""

from repro_torch.compiler.artifact import (ArtifactError, ArtifactStore,
                                           array_digest, load_program,
                                           recipe_digest, save_program)
from repro_torch.compiler.ir import Graph, GraphError, Node
from repro_torch.compiler.lower import (Program, Step, compile_graph,
                                        program_from_numpy)

__all__ = ["Graph", "GraphError", "Node", "Program", "Step", "compile_graph",
           "program_from_numpy", "ArtifactError", "ArtifactStore",
           "array_digest", "save_program", "load_program", "recipe_digest"]
