"""Graph compiler: IR, passes, lowering to a Program, and its executor."""

from repro_torch.compiler.ir import Graph, GraphError, Node
from repro_torch.compiler.lower import (Program, Step, compile_graph,
                                        program_from_numpy)

__all__ = ["Graph", "GraphError", "Node", "Program", "Step", "compile_graph",
           "program_from_numpy"]
