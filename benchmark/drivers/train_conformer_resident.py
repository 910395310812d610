"""Driver ``train_conformer_resident``: ``train --device-resident``'s path for a
Conformer-CTC (`speechless_tpu_torch/models/conformer.py`).

Set-up imports the port's Conformer first (a port without it fails here, before any
input is made), then makes a `DeviceDataset` on the card from the seed: fp16 features at
the mix's hop, zero past each row's frames and padded to its bucket, and labels at
``labels_per_second``. The weights are drawn on the card (`reference/conformer.py`'s
`draw_params`). As `train_resident` does, it drives one `trainer.TrainState` through its
first three steps with ``make_device_epoch_step(..., steps=1)`` on 3 x B distinct rows,
keeping the losses, the first gradient (Adam's first moment after one step, over
1 - b1) and the parameters after the third step, then warms the window's call
(``steps_per_call`` steps, rows drawn on the card) once. The window repeats that call,
each counted when its loss is read back. The check holds the three steps to the plain
reference (`reference/conformer.py`).
"""
import math
import time

import numpy as np
import torch

from benchmark.drivers.train_resident import BETA1, CHECK_STEPS, HalfBatch
from benchmark.harness import conformer_count
from benchmark.harness import traffic as inputs
from benchmark.reference import conformer as plain


def program_config(config: dict, precision: str):
    """The port's `ConformerConfig` for the configuration file's widths."""
    from speechless_tpu_torch.models import conformer

    if (config["subsampling"], config["subsampling_factor"], config["self_attention_model"],
            config["conv_norm_type"], tuple(config["att_context_size"])) != (
            "striding", 4, "rel_pos", "batch_norm", (-1, -1)) or not config["xscaling"]:
        raise ValueError("the port builds striding 4x subsampling and full-context rel_pos "
                         "attention with BatchNorm and x-scaling, not {}".format(config))
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[precision]
    return conformer.ConformerConfig(
        feat_in=config["feat_in"], d_model=config["d_model"], n_heads=config["n_heads"],
        n_layers=config["n_layers"], ff_expansion=config["ff_expansion_factor"],
        conv_kernel=config["conv_kernel_size"],
        subsampling_channels=config["subsampling_conv_channels"],
        grapheme_set_size=config["classes"], compute_dtype=dtype,
        dropout=config["train"]["dropout"])


def corpus(traffic: dict, classes: int, seed: int, device):
    """The resident corpus on ``device``, as `traffic.resident_corpus` makes it but at
    ``hop_samples`` a frame and ``labels_per_second``: fp16 features (zero past each
    row's frames), int32 frame counts, labels uniform over the ``classes - 1`` non-blank
    classes (-1 padded to a multiple of 64) and label counts."""
    rows, bucket = traffic["utterances"], traffic["bucket_frames"]
    samples = np.round(inputs.length_seconds(traffic["lengths"], rows) * inputs.SAMPLE_RATE)
    samples = samples.astype(np.int64)[inputs.permutation(seed, rows)]
    frames = 1 + samples // traffic["hop_samples"]
    if frames.max() > bucket:
        raise ValueError("an utterance of {} frames exceeds the {}-frame bucket".format(
            frames.max(), bucket))
    label_counts = np.round(samples / inputs.SAMPLE_RATE
                            * traffic["labels_per_second"]).astype(np.int64)
    label_width = -(-int(label_counts.max()) // 64) * 64
    generator = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.from_numpy(frames.astype(np.int32)).to(device)
    label_lengths = torch.from_numpy(label_counts.astype(np.int32)).to(device)
    features = torch.empty((rows, bucket, traffic["features"]), dtype=torch.float16,
                           device=device)
    positions = torch.arange(bucket, device=device)
    chunk = traffic.get("chunk_rows", 4096)
    for first in range(0, rows, chunk):
        block = features[first:first + chunk]
        block.normal_(generator=generator)
        block.masked_fill_(positions[None, :, None] >= lengths[first:first + chunk, None, None],
                           0.0)
    labels = torch.randint(0, classes - 1, (rows, label_width), generator=generator,
                           device=device, dtype=torch.int32)
    labels.masked_fill_(torch.arange(label_width, device=device)[None]
                        >= label_lengths[:, None], -1)
    return features, lengths, labels, label_lengths


class Cell:
    def __init__(self, context: dict):
        from speechless_tpu_torch.models import conformer  # noqa: F401 (first: see above)
        from speechless_tpu_torch.data.device_dataset import DeviceDataset
        from speechless_tpu_torch.train import trainer

        record, device, seed = context["record"], context["device"], context["seed"]
        config, mix = record.config, record.traffic
        self.record, self.device, self.mix, self.config = record, device, mix, config
        self.learning_rate = config["train"]["learning_rate"]
        self.batch, self.steps = mix["batch"], mix["steps_per_call"]
        self.program = program_config(config, config["train"]["compute_dtype"])
        record.stage("kernel_load")  # the CTC kernels load at their first launch

        fields = corpus(mix, config["classes"], seed, device)
        self.lengths_host = fields[1].cpu().numpy()
        self.label_counts_host = fields[3].cpu().numpy()
        generator = torch.Generator(device=device).manual_seed(seed)
        self.weights = plain.draw_params(config, generator, device)
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

        optimizer = trainer.make_optimizer(self.learning_rate)
        self.state = trainer.init_train_state(self.program, optimizer, params=self.weights,
                                              seed=seed, device=device)
        if context["fault"] == "unchanged_state":
            opt_state = self.state.opt_state
            opt_state.step = opt_state._clear_grads
        first = trainer.make_device_epoch_step(self.program, optimizer, self.batch, 1)
        self.losses, self.first_gradient = [], None
        named = dict(self.state.model.named_parameters())
        for step in range(CHECK_STEPS):
            self.state, out = first(self.state, self.dataset,
                                    indices=self.check_rows[step:step + 1])
            self.losses.append(float(out["loss"]))
            if step == 0:
                adam = self.state.opt_state.adam.state
                self.first_gradient = {
                    name: adam[p]["exp_avg"] / (1 - BETA1) if p in adam
                    else torch.zeros_like(p) for name, p in named.items()}
        self.after_check = {name: p.detach().clone() for name, p in named.items()}
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
        own-frame FLOPs and the CTC layer's bytes (`harness/conformer_count.py`)."""
        replay = torch.Generator(device=self.device)
        rows = self.dataset.example_count
        cache, flops, ctc_bytes = {}, 0.0, 0.0
        for state in self.sampler_states:
            replay.set_state(state)
            for _ in range(self.steps):
                picked = torch.randperm(rows, generator=replay, device=self.device)[
                    : self.batch].cpu().numpy()
                step_flops, step_bytes = conformer_count.batch_work(
                    self.config, self.lengths_host[picked], self.label_counts_host[picked],
                    cache)
                flops += step_flops
                ctc_bytes += step_bytes
        calls = len(self.sampler_states)
        record.work.update(utterances=calls * self.steps * self.batch, model_flops=flops,
                           ctc_bytes=ctc_bytes, steps=calls * self.steps)

    def release(self) -> None:
        del self.state, self.dataset, self.epoch

    def check(self, record):
        return plain.compare(self)


def setup(context: dict) -> Cell:
    return Cell(context)


def control(cell) -> list:
    """The cell's control: the reference in fp8 (the step below the bf16 it states) in
    the program's place, against the fp32 reference."""
    return plain.control(cell, "fp8")
