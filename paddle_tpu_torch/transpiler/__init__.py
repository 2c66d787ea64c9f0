"""Program transpilers: parameter-server distribution (parity: the JAX
package's transpiler/; the memory-optimization transpiler is not ported
yet)."""
from . import distributed_spliter
from .distribute_transpiler import DistributeTranspiler, VarBlock, \
    split_dense_variable, same_or_split_var
from .distribute_transpiler_simple import SimpleDistributeTranspiler
