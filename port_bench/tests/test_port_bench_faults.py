"""The check catches a broken timed path: each run here skips the look
for a card, drives the rest of a run at a CPU size with one fault planted
in the program underneath, and must come out not correct. The sound run
beside them comes out correct."""

import pytest

from cells import CELLS, execute


def _half_batch(monkeypatch):
    """The transcriber answers only the first half of each batch."""
    from basic_pitch_torch.pipeline import StreamingTranscriber

    real = StreamingTranscriber.transcribe_batch

    def half(self, recordings, **kwargs):
        return real(self, recordings[: max(1, len(recordings) // 2)], **kwargs)

    monkeypatch.setattr(StreamingTranscriber, "transcribe_batch", half)


def _altered_answer(monkeypatch):
    """Each answer's first event comes out a semitone high (the offline
    cells' exact decode-stage comparison sees one such event)."""
    from basic_pitch_torch.pipeline import StreamingTranscriber

    real = StreamingTranscriber.transcribe_batch

    def altered(self, recordings, **kwargs):
        out = []
        for res in real(self, recordings, **kwargs):
            events = res[0] if isinstance(res, tuple) else res
            if events:
                s, e, p, a, b = events[0]
                events[0] = (s, e, p + 1, a, b)
            out.append(res)
        return out

    monkeypatch.setattr(StreamingTranscriber, "transcribe_batch", altered)


def _altered_answers(monkeypatch):
    """Every answer comes out a semitone high."""
    from basic_pitch_torch.pipeline import StreamingTranscriber

    real = StreamingTranscriber.transcribe_batch

    def altered(self, recordings, **kwargs):
        return [[(s, e, p + 1, a, b) for s, e, p, a, b in events] for events in real(self, recordings, **kwargs)]

    monkeypatch.setattr(StreamingTranscriber, "transcribe_batch", altered)


def _train_half_batch(monkeypatch):
    """The step sees half of its batch and takes the mean over it."""
    from basic_pitch_torch.train import loop

    real = loop.train_step

    def half(model, optimizer, batch, config, all_sum=None):
        n = batch["audio"].shape[0] // 2

        def cut(x):
            return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[:n]

        return real(model, optimizer, cut(batch), config, all_sum)

    monkeypatch.setattr(loop, "train_step", half)


def _train_unchanged_state(monkeypatch):
    """The step computes its losses and gradients and updates nothing."""
    from basic_pitch_torch.train import loop

    monkeypatch.setattr(loop, "apply_update", lambda *args, **kwargs: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert execute(workload)["correct"] is True


@pytest.mark.parametrize(
    "workload, fault",
    [
        ("nmp.offline-mixed", _half_batch),
        ("nmp.offline-mixed", _altered_answer),
        ("nmp.serve-poisson", _half_batch),
        ("nmp.serve-poisson", _altered_answers),
        ("train.b16-highest", _train_half_batch),
        ("train.b16-highest", _train_unchanged_state),
    ],
    ids=["offline-half-batch", "offline-altered-answer", "serve-half-batch", "serve-altered-answers",
         "train-half-batch", "train-unchanged-state"],
)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result = execute(workload, seconds=3.0 if workload.endswith("serve-poisson") else 1.0)
    assert result["correct"] is False, result["checks"]
