from .ipm import IPMOptions, IPMResult, make_kernel, make_solver
from .nlp import NLP

__all__ = ["NLP", "IPMOptions", "IPMResult", "make_kernel", "make_solver"]
