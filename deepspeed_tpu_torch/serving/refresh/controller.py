"""Fleet refresh controller: rolling no-drain weight rollout + rollback.

Port of ``deepspeed_tpu/serving/refresh/controller.py``, copied as it
is. A publication comes from the port's :class:`WeightPublisher`; each
replica adopts it through the gateway's staged refresh and the engine's
``swap_params``.

:class:`FleetRefreshController` takes a validated weight publication
and applies it across a :class:`FleetRouter`'s replicas one at a time,
keeping every replica ALIVE throughout — each swap rides the gateway's
staged-refresh protocol (admission held, in-flight streams finish on
the old weights, queued requests wait out the swap), so a rollout
drops zero requests by construction.

Safety gates, in the order they fire:

- **publication gate** — the publication is chain-verified against the
  adopted lineage BEFORE any replica is touched; a torn or forged
  publication is rejected typed with nothing adopted anywhere.
- **canary gate** — after the FIRST replica swaps, its greedy output on
  fixed canary prompts is compared bit-identically against a
  cold-started reference on the new weights (the same replay-equality
  discipline the router's failover uses). Divergence — including a
  replica that *lies* about its version — rolls the fleet back before
  a second replica ever refreshes.
- **rollback** — any mid-swap crash or canary divergence rolls every
  already-refreshed replica back to the previous version through the
  same no-drain path (zero dropped requests); stale new-version KV is
  invalidated by the version-tagged prefix-cache/tier machinery.
- **demotion** — a replica that repeatedly times out or fails to
  converge to the target version is demoted through the health state
  machine (fatal failure -> DOWN, half-open probing owns recovery);
  the rollout continues without it rather than rolling back.
"""

import threading
import time

from deepspeed_tpu_torch.serving.admission import ServingError
from deepspeed_tpu_torch.utils.env_registry import env_int, env_opt_bool
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import WeightPublicationError, tracked_lock


# ---------------------------------------------------------------------- errors
class WeightRefreshError(ServingError):
    """A fleet weight rollout failed (and, where possible, rolled
    back). Request-terminal from a router's point of view."""
    reason = "weight_refresh"
    retry_elsewhere = False


class CanaryDivergenceError(WeightRefreshError):
    """The first refreshed replica's greedy output differs from a
    cold-started engine on the same weights — the refresh path and a
    cold start disagree, so the publication must not roll out."""
    reason = "canary_divergence"


class FleetRefreshController:
    """Rolls weight publications across ``router``'s replicas.

    ``reference_fn(params, prompt_tokens, max_new_tokens) -> [token,
    ...]`` is the canary oracle: it must COLD-START an engine on
    ``params`` and greedy-decode — never reuse a refreshed engine, or
    the gate compares the refresh path against itself. ``canary_prompts``
    are the fixed prompts the gate replays (defaults to a small spread
    of short prompts).

    ``baseline_params`` is the rollback target while no publication has
    been adopted yet (the replicas' as-built weights, version 0);
    without it a rollback from the very first rollout has nowhere to
    go and the affected replicas are demoted instead.
    """

    def __init__(self, router, publisher=None, reference_fn=None,
                 canary_prompts=None, baseline_params=None):
        self.router = router
        self.publisher = publisher
        self.config = router.config
        self.reference_fn = reference_fn
        self.canary_prompts = [list(p) for p in (
            canary_prompts or [[1, 2, 3, 4], [7, 5, 3], [11, 13]])]
        self._lock = tracked_lock(threading.Lock(),
                                  "FleetRefreshController._lock")
        self.current_version = 0
        self.current_chain = None
        self._adopted_params = baseline_params
        self.rollouts = 0  # completed successful rollouts

    # ------------------------------------------------------------- resolution
    def _canary_enabled(self):
        forced = env_opt_bool("DS_REFRESH_CANARY")
        on = forced if forced is not None else self.config.refresh_canary
        if on and self.reference_fn is None:
            raise WeightRefreshError(
                "refresh canary gate is enabled but the controller has no "
                "reference_fn — pass one (cold-start oracle) or disable "
                "the gate explicitly")
        return on

    def _timeout(self):
        t = env_int("DS_REFRESH_TIMEOUT_S")
        return float(t) if t > 0 else self.config.refresh_timeout_s

    def _ordered_replicas(self):
        """Rollout order: routable replicas first (healthy canary
        candidates), non-routable last, DOWN skipped entirely — the
        health machinery owns dead replicas, not the rollout."""
        routable, rest = [], []
        for name, rep in self.router.replicas.items():
            h = self.router.health[name]
            if not h.routable:
                if h.snapshot()["state"] == "down":
                    continue
                rest.append((name, rep))
            else:
                routable.append((name, rep))
        return routable + rest

    # ---------------------------------------------------------------- rollout
    def rollout(self, version=None, params=None, manifest=None):
        """Apply one publication fleet-wide. Returns a report dict:
        ``{version, previous_version, refreshed, demoted, rolled_back,
        reason, canary, wall_s}``.

        Source resolution: explicit ``params`` (+ optional ``manifest``)
        or, when ``params`` is None, ``publisher.load(version)`` with
        the lineage pinned to the adopted chain. A publication that
        fails validation raises :class:`WeightPublicationError` with no
        replica touched. Canary divergence and mid-swap crashes roll
        the fleet back and report ``rolled_back=True`` rather than
        raising — the fleet is healthy on the old version, which is a
        recovered state, not an exception."""
        t0 = time.monotonic()
        with self._lock:
            if params is None:
                if self.publisher is None:
                    raise WeightRefreshError(
                        "rollout needs params or a publisher")
                params, manifest = self.publisher.load(
                    version, expect_parent_chain=self.current_chain
                    if self.current_chain is not None else False)
            if manifest is not None:
                version = int(manifest["weight_version"])
            if version is None:
                raise WeightRefreshError("rollout needs a target version")
            version = int(version)
            if version == self.current_version:
                raise WeightRefreshError(
                    f"rollout target v{version} is already the adopted "
                    f"version")
            prev_version = self.current_version
            prev_params = self._adopted_params
            canary_on = self._canary_enabled()

            report = {"version": version, "previous_version": prev_version,
                      "refreshed": [], "demoted": [], "rolled_back": False,
                      "reason": None,
                      "canary": "pending" if canary_on else "skipped"}
            for name, rep in self._ordered_replicas():
                outcome = self._refresh_one(name, rep, params, version)
                if outcome == "ok":
                    report["refreshed"].append(name)
                elif outcome == "demoted":
                    report["demoted"].append(name)
                    continue
                else:  # crashed mid-swap
                    self.router.health[name].record_failure(
                        f"crashed mid-swap to v{version}", fatal=True)
                    self._rollback(report, prev_version, prev_params,
                                   f"replica {name} crashed mid-swap")
                    report["wall_s"] = time.monotonic() - t0
                    return report
                if canary_on and report["canary"] == "pending":
                    diverged = self._canary(name, rep, params, version)
                    if diverged:
                        report["canary"] = "diverged"
                        self.router._count("canary_divergences")
                        self._rollback(report, prev_version, prev_params,
                                       f"canary divergence on {name}: "
                                       f"{diverged}")
                        report["wall_s"] = time.monotonic() - t0
                        return report
                    report["canary"] = "passed"

            if not report["refreshed"]:
                raise WeightRefreshError(
                    f"rollout to v{version}: no replica adopted the "
                    f"publication (demoted: {report['demoted']})")
            self.current_version = version
            self.current_chain = (manifest or {}).get("chain",
                                                      self.current_chain)
            self._adopted_params = params
            self.rollouts += 1
            self.router._count("refreshes")
            report["wall_s"] = time.monotonic() - t0
            logger.info(
                f"refresh: v{prev_version} -> v{version} adopted on "
                f"{len(report['refreshed'])} replica(s) in "
                f"{report['wall_s']:.3f}s (demoted: {report['demoted']})")
            return report

    def _refresh_one(self, name, rep, params, version):
        """One replica's swap with bounded retries. → 'ok' | 'demoted' |
        'crashed'. Convergence failures (timeout, version mismatch after
        a claimed success) retry then demote; a crash is terminal for
        the whole rollout (caller rolls back)."""
        health = self.router.health[name]
        for attempt in range(1, self.config.refresh_demote_after + 1):
            try:
                rep.refresh(params, version, timeout=self._timeout())
            except (TimeoutError,) as e:
                logger.warning(f"refresh: {name} attempt {attempt} timed "
                               f"out: {e}")
                continue
            except WeightPublicationError as e:
                # the publication tore between validation and this
                # replica — trust nothing derived from it
                logger.error(f"refresh: {name} rejected the publication "
                             f"typed: {e}")
                return "crashed"
            except BaseException as e:
                logger.error(f"refresh: {name} crashed mid-swap: "
                             f"{type(e).__name__}: {e}")
                return "crashed"
            got = rep.weight_version()
            if got == version:
                return "ok"
            logger.warning(f"refresh: {name} reports v{got} after a "
                           f"claimed swap to v{version} (attempt "
                           f"{attempt})")
        health.record_failure(f"failed to converge to weight v{version}",
                              fatal=True)  # demote: DOWN + half-open probe
        self.router._count("refresh_demotions")
        logger.error(f"refresh: {name} failed to converge to v{version} "
                     f"after {self.config.refresh_demote_after} attempts — "
                     f"demoted")
        return "demoted"

    # ----------------------------------------------------------------- canary
    def _canary(self, name, rep, params, version):
        """Greedy-replay the canary prompts on the refreshed replica and
        compare bit-identically with the cold-start oracle. → None when
        identical, else a human-readable divergence description."""
        max_new = self.config.refresh_canary_max_new
        for prompt in self.canary_prompts:
            expect = [int(t) for t in
                      self.reference_fn(params, list(prompt), max_new)]
            try:
                handle = rep.submit(list(prompt), max_new_tokens=max_new)
                got = [int(t) for t in handle.tokens(timeout=self._timeout())]
            except Exception as e:
                return (f"canary request failed on {name}: "
                        f"{type(e).__name__}: {e}")
            if got != expect:
                return (f"prompt {prompt}: cold start emits {expect}, "
                        f"refreshed replica emits {got}")
        return None

    # --------------------------------------------------------------- rollback
    def _rollback(self, report, prev_version, prev_params, why):
        """Return every already-refreshed replica to the previous
        version via the same no-drain path. A replica that cannot roll
        back is demoted — the fleet must never serve two weight
        versions that both claim to be current."""
        report["rolled_back"] = True
        report["reason"] = why
        self.router._count("refresh_rollbacks")
        logger.error(f"refresh: rolling back to v{prev_version}: {why}")
        survivors = []
        for name in report["refreshed"]:
            rep = self.router.replicas[name]
            if prev_params is None:
                ok = False
            else:
                try:
                    rep.refresh(prev_params, prev_version,
                                timeout=self._timeout())
                    ok = rep.weight_version() == prev_version
                except BaseException as e:
                    logger.error(f"refresh: rollback of {name} failed: "
                                 f"{type(e).__name__}: {e}")
                    ok = False
            if ok:
                survivors.append(name)
            else:
                self.router.health[name].record_failure(
                    f"stuck on v{report['version']} after a rollback to "
                    f"v{prev_version}", fatal=True)
                self.router._count("refresh_demotions")
                report["demoted"].append(name)
                logger.error(f"refresh: {name} could not roll back to "
                             f"v{prev_version} — demoted")
        report["refreshed"] = []
        report["rolled_back_replicas"] = survivors
