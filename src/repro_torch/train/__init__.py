from .step import loss_and_grads, make_serve_step, make_train_step

__all__ = ["loss_and_grads", "make_serve_step", "make_train_step"]
