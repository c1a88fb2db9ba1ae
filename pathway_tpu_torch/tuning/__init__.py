"""Workload-driven autotuner for the knob table (counterpart of
``pathway_tpu/tuning/``).

``python -m pathway_tpu_torch tune <profile>`` searches the tunable knobs
for one :data:`~pathway_tpu_torch.tuning.profiles.PROFILES` entry on the
card, validates survivors under the SLO watchdog and a chaos drill, and
persists the winner as a tuned-config JSON in JAX's format. Constructors
load it through ``tuned_config=<path>`` (``DecoderChat``,
``SentenceEmbedderModel``, ``QueryServer``, ``EngineConfig``); an argument
the caller passes still wins, knob by knob."""

from pathway_tpu_torch.tuning.profiles import (  # noqa: F401
    PROFILES,
    WorkloadProfile,
    decoder_resources,
    get_profile,
    run_trial,
)
from pathway_tpu_torch.tuning.search import (  # noqa: F401
    Autotuner,
    TuneError,
    TuneResult,
    candidate_axes,
    save_artifact,
    to_artifact,
)
