"""EngineCore: the scheduler + worker inner loop, synchronous."""
from __future__ import annotations

from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.core.scheduler import EngineCoreOutput, Scheduler
from aphrodite_tpu_torch.worker.worker import Worker


class EngineCore:

    def __init__(self, config: EngineConfig) -> None:
        self.config = config
        self.worker = Worker(config)
        # Lookahead KV slots cover the decode window; a recurrent-state
        # model writes no KV and needs none.
        lookahead = (0 if getattr(self.worker.model, "is_ssm", False)
                     else config.max_lookahead_tokens)
        self.scheduler = Scheduler(
            config.scheduler_config, config.cache_config,
            num_lookahead_tokens=lookahead)

    def reset_prefix_cache(self) -> bool:
        return self.scheduler.kv.reset_prefix_cache()

    def step(self) -> list[EngineCoreOutput]:
        if not self.scheduler.has_unfinished_requests():
            return []
        sched_out = self.scheduler.schedule()
        runner_out = self.worker.runner.execute_model(sched_out)
        return self.scheduler.update_from_output(sched_out, runner_out)
