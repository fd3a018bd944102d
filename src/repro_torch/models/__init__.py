"""The model zoo's serving path in PyTorch: ``config`` (a copy of the JAX
package's), ``blocks``, ``transformer`` and ``model``."""
