"""ZeroShotClassificationPipeline: the user-facing end-to-end API.

Covers the reference's whole flow (main.c: parse job -> preprocess -> infer ->
postprocess -> report) as one object:

    pipe = ZeroShotClassificationPipeline.from_bundle("path/to/bundle")
    results = pipe(texts, labels, classification_type="multi-label")

plus ``classify_job`` for the reference's JSON job contract (reference
Readme.md:121-150) and a reference-format report.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .config import RuntimeConfig
from .data import ClassificationJob
from .engine import InferenceEngine
from .parallel.scheduler import plan_and_run_overlapped, plan_batches, run_planned
from .postprocess import TextResult, decide_batch, format_report
from .prompting import pack_prompts
from .tokenization import AffixEncoder, PromptTokenizer
from .utils import metrics
from .utils.metrics import StageTimer


@dataclass
class JobOutput:
    results: list[TextResult]
    probs: np.ndarray  # [num_texts, max_label_count] f32
    report: str
    timings: dict | None = None  # per-stage breakdown (utils.metrics)
    # Batches that failed after their one retry: the affected texts'
    # probability rows are 0 and their results carry no decisions.
    failures: list = None  # list[parallel.scheduler.BatchFailure]

    @property
    def failed_indices(self) -> set[int]:
        return {i for f in (self.failures or []) for i in f.indices}

    def to_json(self) -> list[dict]:
        failed = self.failed_indices
        out = []
        for r in self.results:
            d = r.to_dict()
            if r.text_index in failed:
                d["error"] = next(f.error for f in self.failures if r.text_index in f.indices)
            out.append(d)
        return out


class ZeroShotClassificationPipeline:
    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: PromptTokenizer,
        runtime: RuntimeConfig | None = None,
        prompt_first: bool | None = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.runtime = runtime or engine.runtime
        # prompt_first comes from the bundle config unless overridden.
        self.prompt_first = engine.cfg.prompt_first if prompt_first is None else prompt_first

    @classmethod
    def from_bundle(
        cls,
        bundle_path: str,
        runtime: RuntimeConfig | None = None,
        device=None,
        prompt_first: bool | None = None,
        mesh=None,
    ) -> "ZeroShotClassificationPipeline":
        """``mesh``: this rank's ``parallel.mesh.Mesh`` (default from
        ``runtime.dp_size``/``sp_size``/``tp_size``, see ``InferenceEngine``)."""
        from .convert import bundle as B

        engine = InferenceEngine.from_bundle(bundle_path, runtime, device, mesh)
        tokenizer = PromptTokenizer.from_file(B.tokenizer_path(bundle_path))
        return cls(engine, tokenizer, runtime, prompt_first)

    # ------------------------------------------------------------------
    def predict_probs(
        self,
        texts: Sequence[str],
        labels: Sequence[Sequence[str]],
        same_labels: bool,
        timer=None,
        failures: list | None = None,
    ) -> np.ndarray:
        """[num_texts, max_label_count] per-label probabilities.

        ``failures``: optional list collecting BatchFailure records (one retry
        per failed batch first); without it a persistent failure raises."""
        timer = timer if timer is not None else StageTimer()
        counts = [len(labels[0]) if same_labels else len(labels[i]) for i in range(len(texts))]
        cap = self.engine.cfg.max_num_classes
        if cap and max(counts) > cap:
            # Beyond the model's trained label capacity scores are unreliable;
            # the batch path warns (the reference never checks).
            warnings.warn(
                f"{max(counts)} labels exceeds the model's max_num_classes "
                f"({cap}); scores beyond the trained capacity are unreliable "
                f"— split the label set across requests",
                stacklevel=3,
            )
        if self.runtime.overlap_enabled():
            pf, L = self.prompt_first, self.runtime.max_length
            affix = None
            if same_labels and texts:
                # The shared label block is encoded once per job; composition
                # is verified against a full-string encode and the packed path
                # is kept when the tokenizer breaks the identity.
                affix = AffixEncoder.for_labels(self.tokenizer, labels[0], pf, L, sample_text=texts[0])
            if affix is not None and affix.exact:
                def chunk_task(lo: int, hi: int):
                    return affix.task(texts[lo:hi], L)
            else:
                def chunk_task(lo: int, hi: int):
                    chunk = pack_prompts(texts[lo:hi], labels if same_labels else labels[lo:hi], same_labels, pf)
                    return self.tokenizer.task(chunk, L)

            with timer.stage("tokenize_device"):
                probs = plan_and_run_overlapped(
                    self.engine, self.tokenizer, counts, self.runtime, len(texts), max(counts), chunk_task,
                    failures=failures, timer=timer,
                )
        else:
            with timer.stage("pack"):
                prompts = pack_prompts(texts, labels, same_labels, self.prompt_first)
            with timer.stage("tokenize_plan"):
                planned = plan_batches(self.tokenizer, prompts, counts, self.runtime)
            with timer.stage("device"):
                probs = run_planned(self.engine, planned, len(texts), max(counts), failures=failures)
        timer.add_count("texts", len(texts))
        return probs

    def predict_logits(
        self, texts: Sequence[str], labels: Sequence[Sequence[str]], same_labels: bool
    ) -> np.ndarray:
        """[num_texts, max_label_count] per-label logits: :meth:`predict_probs`
        (the same tokenization, buckets and forwards) before the sigmoid."""
        with self.engine.returning_logits():
            return self.predict_probs(texts, labels, same_labels)

    def __call__(
        self,
        texts: Sequence[str] | str,
        labels: Sequence[Sequence[str]] | Sequence[str],
        classification_type: str = "multi-label",
        threshold: float | None = None,
    ) -> list[TextResult]:
        """gliclass-package-style API: shared label list, or one list per text."""
        if isinstance(texts, str):
            texts = [texts]
        same_labels = bool(labels) and isinstance(labels[0], str)
        if same_labels:
            labels = [list(labels)]
        probs = self.predict_probs(texts, labels, same_labels)
        counts = [len(labels[0]) if same_labels else len(labels[i]) for i in range(len(texts))]
        return decide_batch(
            probs, texts, labels, same_labels, classification_type,
            self.runtime.threshold if threshold is None else threshold,
            num_valid=counts, use_native=self.runtime.use_native_host_ops,
        )

    # ------------------------------------------------------------------
    def classify_job(self, job: ClassificationJob) -> JobOutput:
        """The reference CLI contract end to end (reference main.c:116-155).
        With the recorder on, a ``job`` span (a new job id, the texts) with
        the ``StageTimer`` stages inside it."""
        rec = metrics.RECORDER
        if rec is None:
            return self._classify_job(job)
        with rec.span("job", {"job": rec.new_id()}, texts=job.num_texts):
            return self._classify_job(job)

    def _classify_job(self, job: ClassificationJob) -> JobOutput:
        timer = StageTimer()
        failures: list = []
        probs = self.predict_probs(job.texts, job.labels, job.same_labels, timer, failures=failures)
        counts = [len(job.labels_for(i)) for i in range(job.num_texts)]
        with timer.stage("decide"):
            results = decide_batch(
                probs, job.texts, job.labels, job.same_labels, job.classification_type,
                self.runtime.threshold, num_valid=counts,
                use_native=self.runtime.use_native_host_ops,
            )
        return JobOutput(results, probs, format_report(results), timer.to_dict(), failures=failures)
