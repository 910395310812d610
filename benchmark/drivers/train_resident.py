"""Driver ``train_resident``: what ``train --device-resident`` runs.

Set-up makes a `DeviceDataset` on the card from the seed (features fp16, padded to the
mix's bucket, as `pack_dataset` pads), the weights (Glorot-uniform, drawn on the card),
and one `trainer.TrainState`. It drives that state through its first three steps with
``make_device_epoch_step(..., steps=1)`` on 3 x B distinct rows, keeping the losses,
the first gradient (Adam's first moment after one step, over 1 - b1) and the
parameters after the third step; then warms the window's call,
``make_device_epoch_step(..., steps=steps_per_call)``, once. The window repeats that
call, rows drawn on the card from the sampling generator, each call counted when its
loss is read back. The check holds the three steps to the plain reference
(`reference/train.py`).
"""
import math
import time

import torch

from benchmark.harness import traffic as inputs
from benchmark.harness import yardstick
from benchmark.reference import w2l as plain

CHECK_STEPS = 3
BETA1 = 0.9


def program_config(config: dict, precision: str):
    """The port's `Wav2LetterConfig` for ``config``; raises unless its layer stack is
    the one the configuration file states."""
    from speechless_tpu_torch.models import wav2letter as w2l

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[precision]
    program = w2l.Wav2LetterConfig(input_size_per_time_step=config["input_size"],
                                   grapheme_set_size=config["classes"], compute_dtype=dtype)
    stated = [(l["name"], l["filters"], l["kernel_size"], l["stride"])
              for l in config["layers"]]
    built = [(s.name, s.filters, s.kernel_size, s.stride) for s in program.layers]
    if stated != built:
        raise ValueError("the port builds {} for {}, not {}".format(built, config["name"],
                                                                     stated))
    return program


def jax_layout(weights) -> list:
    """The port's parameter list (``w`` as ``(K, C_in, C_out)``) on the host."""
    return [{"w": w.permute(2, 1, 0).cpu().numpy(), "b": b.cpu().numpy()}
            for w, b in weights]


class HalfBatch:
    """A fault for the tests: the dataset hands the step the first half of its rows."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.example_count = dataset.example_count
        self.inputs = dataset.inputs

    def gather(self, rows):
        return tuple(field[: len(rows) // 2] for field in self.dataset.gather(rows))


class Cell:
    def __init__(self, context: dict):
        from speechless_tpu_torch.data.device_dataset import DeviceDataset
        from speechless_tpu_torch.models import wav2letter as w2l
        from speechless_tpu_torch.train import trainer

        record, device, seed = context["record"], context["device"], context["seed"]
        config, mix = record.config, record.traffic
        self.record, self.device, self.mix = record, device, mix
        self.train = config["train"]
        self.layers = config["layers"]
        self.input_size = config["input_size"]
        self.frozen = self.train["frozen_layers"]
        self.batch, self.steps = mix["batch"], mix["steps_per_call"]
        record.stage("kernel_load")  # the CTC kernels load at their first launch

        fields = inputs.resident_corpus(mix, config["classes"], seed, device)
        self.lengths_host = fields[1].cpu().numpy()
        self.label_counts_host = fields[3].cpu().numpy()
        generator = torch.Generator(device=device).manual_seed(seed)
        self.weights = plain.glorot_weights(self.layers, self.input_size, generator, device)
        rows = fields[0].shape[0]
        self.check_rows = torch.randperm(rows, generator=generator, device=device)[
            : CHECK_STEPS * self.batch].view(CHECK_STEPS, self.batch)
        self.check_batches = [tuple(f.index_select(0, r) for f in fields)
                              for r in self.check_rows]
        dataset = DeviceDataset(*fields)
        if context["fault"] == "half_batch":
            dataset = HalfBatch(dataset)
        self.dataset = dataset
        if device.type == "cuda":
            torch.cuda.synchronize()
        record.stage("inputs")

        self.program = program_config(config, self.train["compute_dtype"])
        trainable = w2l.trainable_mask(self.program, self.frozen)
        optimizer = trainer.make_optimizer(self.train["learning_rate"], trainable=trainable)
        self.state = trainer.init_train_state(self.program, optimizer,
                                              params=jax_layout(self.weights), seed=seed,
                                              device=device)
        if context["fault"] == "unchanged_state":
            opt_state = self.state.opt_state
            opt_state.step = opt_state._clear_grads
        self.trainable = trainable
        first = trainer.make_device_epoch_step(self.program, optimizer, self.batch, 1)
        self.losses, self.first_gradient = [], None
        for step in range(CHECK_STEPS):
            self.state, out = first(self.state, self.dataset,
                                    indices=self.check_rows[step:step + 1])
            self.losses.append(float(out["loss"]))
            if step == 0:
                adam = self.state.opt_state.adam.state
                self.first_gradient = [
                    [adam[p]["exp_avg"] / (1 - BETA1) if p in adam else None
                     for p in (conv.weight, conv.bias)] for conv in self.state.model.layers]
        self.after_check = [[p.detach().clone() for p in (conv.weight, conv.bias)]
                            for conv in self.state.model.layers]
        self.epoch = trainer.make_device_epoch_step(self.program, optimizer, self.batch,
                                                    self.steps)
        self.sampler = torch.Generator(device=device).manual_seed(seed + 1)
        self.state, out = self.epoch(self.state, self.dataset, self.sampler)
        float(out["loss"])
        record.stage("warm_up")
        self.sampler_states = []

    def window(self, record, seconds: float) -> None:
        start = time.perf_counter()
        while True:
            self.sampler_states.append(self.sampler.get_state())
            with record.span("train_call"):
                self.state, out = self.epoch(self.state, self.dataset, self.sampler)
                loss = float(out["loss"])
            record.attempted += 1
            record.failed += 0 if math.isfinite(loss) else 1
            if time.perf_counter() - start >= seconds:
                break

    def finish(self, record) -> None:
        """The rows each call trained on, replayed from the sampling generator's state
        before it (`trainer.sample_indices` draws one ``randperm`` a step), for the
        own-frame FLOPs and the CTC layer's bytes."""
        replay = torch.Generator(device=self.device)
        rows = self.dataset.example_count
        per_length = {}
        flops = ctc_bytes = 0.0
        classes = self.layers[-1]["filters"]
        for state in self.sampler_states:
            replay.set_state(state)
            for _ in range(self.steps):
                picked = torch.randperm(rows, generator=replay, device=self.device)[
                    : self.batch].cpu().numpy()
                frames = self.lengths_host[picked]
                for length in frames:
                    if length not in per_length:
                        per_length[length] = yardstick.train_flops(
                            self.layers, self.input_size, int(length), self.frozen)
                    flops += per_length[length]
                ctc_bytes += yardstick.ctc_bytes(frames // 2,
                                                 self.label_counts_host[picked], classes)
        calls = len(self.sampler_states)
        record.work.update(utterances=calls * self.steps * self.batch, model_flops=flops,
                           ctc_bytes=ctc_bytes, steps=calls * self.steps)

    def release(self) -> None:
        del self.state, self.dataset, self.epoch

    def check(self, record):
        from benchmark.reference import train as reference

        return reference.compare(self, precision="fp32")


def setup(context: dict) -> Cell:
    return Cell(context)


def control(cell) -> list:
    """The cell's control: the reference in fp8 (the step below the bf16 it states) in
    the program's place, against the fp32 reference."""
    from benchmark.reference import train as reference

    return reference.control(cell, "fp8")
