from .ipm import (IPMOptions, IPMResult, make_chunked_solver, make_kernel,
                  make_solver)
from .nlp import NLP

__all__ = ["NLP", "IPMOptions", "IPMResult", "make_chunked_solver",
           "make_kernel", "make_solver"]
