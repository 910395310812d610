"""Driver ``serve_batch``: a batch-transcription user, closed loop.

Set-up makes the weights (Glorot-uniform on the card, the output layer scaled for peaky
frames), ``utterances`` clips of seeded audio whose lengths are the mix's quantiles in
a seeded order, and the word trigram (frozen builder, into ``TMPDIR``), builds one
`Transcriber` with the LM beam over them, and runs one call to warm every bucket the
clips use. Each call of the window is ``transcribe_batch(clips, batch_size)``; its audio
counts when the call returns. The check holds the last call's sampled transcripts and
the log-probs their dispatches computed to the reference (`reference/serve.py`).
"""
import time

from benchmark.harness.serving import Serving, sync


class Cell:
    def __init__(self, context: dict):
        record, self.device = context["record"], context["device"]
        self.fault = context["fault"]
        self.serving = Serving(record, self.device, context["seed"],
                               record.traffic["utterances"], self.fault)
        self.batch_size = record.traffic["batch_size"]
        self.texts = self._call()
        sync(self.device)
        record.stage("warm_up")

    def _call(self):
        results = self.serving.transcriber.transcribe_batch(self.serving.clips,
                                                            batch_size=self.batch_size)
        texts = [text for text, _ in results]
        if self.fault == "altered_answer":
            texts[self.serving.sample[0]] = texts[self.serving.sample[0]][::-1] + "q"
        if self.fault == "half_batch":
            texts = [text if index % 2 == 0 else None for index, text in enumerate(texts)]
        return texts

    def window(self, record, seconds: float) -> None:
        self.serving.observer.counting = True
        start = time.perf_counter()
        calls = 0
        while True:
            with record.span("transcribe_batch"):
                self.texts = self._call()
            calls += 1
            record.attempted += len(self.texts)
            record.failed += sum(text is None for text in self.texts)
            if time.perf_counter() - start >= seconds:
                break
        self.serving.observer.counting = False
        samples = self.serving.samples
        record.work.update(audio_s=calls * float(samples.sum()) / 16000.0,
                           model_flops=calls * sum(self.serving.flops),
                           span_bytes=self.serving.span_bytes(), calls=calls)

    def finish(self, record) -> None:
        pass

    def release(self) -> None:
        self.serving.release()

    def check(self, record):
        from benchmark.reference import serve as reference

        served = {index: self.texts[index] for index in self.serving.sample}
        return reference.compare(self.serving, served, missing=sum(
            text is None for text in self.texts))


def setup(context: dict) -> Cell:
    return Cell(context)


def control(cell) -> list:
    """The control: the reference with TF32 on (the step below the IEEE fp32 the
    configuration states) in the program's place, against the fp32 reference."""
    from benchmark.reference import serve as reference

    return reference.control(cell.serving, "tf32")
