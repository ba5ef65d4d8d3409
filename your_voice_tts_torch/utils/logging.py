"""Console lines of the trainer (the JAX package's utils/logging.py
ConsoleLogger, the lines `fit` and `evaluate` print)."""

from __future__ import annotations


class ConsoleLogger:
    BOLD, BLUE, GREEN, END = "\033[1m", "\033[94m", "\033[92m", "\033[0m"

    def print_epoch_start(self, epoch: int, max_epoch: int) -> None:
        print(f"\n{self.BOLD} > EPOCH: {epoch}/{max_epoch}{self.END}", flush=True)

    def print_train_step(self, batch_steps: int, step: int, global_step: int,
                         loss_dict: dict) -> None:
        msg = f"{self.BLUE}   --> STEP: {step}/{batch_steps} -- GLOBAL_STEP: {global_step}{self.END}"
        for k, v in loss_dict.items():
            msg += f" | {k}: {float(v):.5f}"
        print(msg, flush=True)

    def print_eval_start(self) -> None:
        print(f"{self.BOLD} > EVALUATION {self.END}", flush=True)

    def print_epoch_end(self, epoch: int, avg_loss_dict: dict) -> None:
        msg = f"{self.GREEN}   --> EPOCH END -- {epoch} {self.END}"
        for k, v in avg_loss_dict.items():
            msg += f" | avg_{k}: {float(v):.5f}"
        print(msg, flush=True)
