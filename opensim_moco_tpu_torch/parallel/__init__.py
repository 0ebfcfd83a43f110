from .batch import batch_guesses, make_batched_solver

__all__ = ["make_batched_solver", "batch_guesses"]
