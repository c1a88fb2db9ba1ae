"""Hidden Markov Model decoding as a stateful reducer.

Counterpart of ``pathway_tpu/stdlib/ml/hmm.py``; reference surface:
``stdlib/ml/hmm.py`` ``create_hmm_reducer(graph,
beam_size, num_results_kept)`` — a reducer that Viterbi-decodes the most
likely hidden-state sequence from a stream of observations grouped per key.

The HMM is described as a ``networkx.DiGraph``: each node carries a
``calc_emission_log_ppb(observation) -> float`` attribute and each edge a
``log_transition_ppb`` weight. The engine's stateful reducer replays the
group's *multiset* of rows on every consolidation (retraction-safe but
order-free: duplicates are netted to counts), so for a meaningful sequence
pass an explicit ordering column as the second reducer argument —
``reducer(this.observation, this.t)`` — and the decode sorts by it. With a
single argument the replay order groups equal observations together.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import reducers as reducers_mod


def create_hmm_reducer(graph, beam_size: int | None = None,
                       num_results_kept: int | None = None):
    """Build a reducer decoding the HMM state sequence from observations.

    Args:
        graph: ``networkx.DiGraph`` whose nodes have a
            ``calc_emission_log_ppb`` callable attribute and whose edges have
            ``log_transition_ppb`` weights.
        beam_size: keep only the best ``beam_size`` states per step
            (beam search); None = exact Viterbi over all states.
        num_results_kept: truncate the decoded sequence to its most recent
            ``num_results_kept`` states; None = keep all.

    Returns a reducer usable in ``groupby(...).reduce(
    decoded=reducer(this.observation, this.t))``; the value is a tuple of
    decoded states, most recent last. The second (ordering) argument is
    optional but required for correct sequencing when the same observation
    value can recur non-consecutively.
    """
    states = list(graph.nodes)
    emission = {
        s: graph.nodes[s]["calc_emission_log_ppb"] for s in states
    }
    # incoming transitions per target state
    incoming: dict[Any, list[tuple[Any, float]]] = {s: [] for s in states}
    for u, v, data in graph.edges(data=True):
        incoming[v].append((u, float(data["log_transition_ppb"])))

    def decode(_state, rows):
        entries: list[tuple] = []
        for args, count in rows:
            for _ in range(count):
                entries.append(args)
        if not entries:
            return ()
        if entries and len(entries[0]) > 1:  # (observation, order_key)
            entries.sort(key=lambda a: a[1])
        observations = [a[0] for a in entries]

        # Viterbi with optional beam pruning; log-probs, paths per state
        logp: dict[Any, float] = {}
        path: dict[Any, tuple] = {}
        first = observations[0]
        for s in states:
            logp[s] = float(emission[s](first))
            path[s] = (s,)
        for obs in observations[1:]:
            new_logp: dict[Any, float] = {}
            new_path: dict[Any, tuple] = {}
            for v in states:
                best = None
                best_u = None
                for u, w in incoming[v]:
                    lp = logp.get(u)
                    if lp is None:
                        continue
                    cand = lp + w
                    if best is None or cand > best:
                        best, best_u = cand, u
                if best is None:
                    continue
                new_logp[v] = best + float(emission[v](obs))
                new_path[v] = path[best_u] + (v,)
            if not new_logp:  # no reachable state: restart from this obs
                for s in states:
                    new_logp[s] = float(emission[s](obs))
                    new_path[s] = (s,)
            if beam_size is not None and len(new_logp) > beam_size:
                kept = sorted(new_logp, key=new_logp.get, reverse=True)
                kept = kept[:beam_size]
                new_logp = {s: new_logp[s] for s in kept}
                new_path = {s: new_path[s] for s in kept}
            logp, path = new_logp, new_path

        best_state = max(logp, key=logp.get)
        decoded = path[best_state]
        if num_results_kept is not None:
            decoded = decoded[-num_results_kept:]
        return decoded

    return reducers_mod.stateful_many(decode)
