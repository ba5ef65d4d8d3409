"""The trainer's loggers (the JAX package's utils/logging.py): the console
lines `fit` and `evaluate` print (`ConsoleLogger`) and TensorBoard events
(`TensorboardLogger`, through tensorboardX where it is installed)."""

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


class TensorboardLogger:
    """Scalars, figures and audio for TensorBoard through tensorboardX (the
    JAX package's TensorboardLogger). Without tensorboardX, or without a
    log directory, `writer` is None and every method does nothing."""

    def __init__(self, log_dir: str | None):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(log_dir)

    def _scalars(self, scope: str, step: int, d: dict) -> None:
        if self.writer is None:
            return
        for k, v in d.items():
            try:
                self.writer.add_scalar(f"{scope}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def tb_train_iter_stats(self, step: int, stats: dict) -> None:
        self._scalars("TrainIterStats", step, stats)

    def tb_train_epoch_stats(self, step: int, stats: dict) -> None:
        self._scalars("TrainEpochStats", step, stats)

    def tb_eval_stats(self, step: int, stats: dict) -> None:
        self._scalars("EvalStats", step, stats)

    def tb_train_figures(self, step: int, figures: dict) -> None:
        if self.writer is None:
            return
        for k, fig in figures.items():
            self.writer.add_figure(f"TrainFigures/{k}", fig, step)

    def tb_eval_figures(self, step: int, figures: dict) -> None:
        if self.writer is None:
            return
        for k, fig in figures.items():
            self.writer.add_figure(f"EvalFigures/{k}", fig, step)

    def tb_eval_audios(self, step: int, audios: dict, sample_rate: int) -> None:
        if self.writer is None:
            return
        for k, wav in audios.items():
            try:
                self.writer.add_audio(f"EvalAudios/{k}", wav[None, :], step,
                                      sample_rate=sample_rate)
            except Exception:
                # tensorboardX's audio encoder needs soundfile, which may be
                # absent; a log write does not stop training
                return

    def tb_model_weights(self, step: int, model) -> None:
        """Each parameter's norm and histogram (training.tb_model_param_stats),
        under its JAX-package key path (`train.checkpoint.params_to_jax`)."""
        if self.writer is None:
            return
        import numpy as np

        from ..train.checkpoint import params_to_jax

        for key, arr in params_to_jax(model)[0].items():
            name = key.replace("'", "").replace("][", "/").strip("[]")
            try:
                self.writer.add_scalar(f"ModelParams/{name}/norm", float(np.linalg.norm(arr)),
                                       step)
                self.writer.add_histogram(f"ModelParams/{name}", arr, step)
            except Exception:
                return

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()
