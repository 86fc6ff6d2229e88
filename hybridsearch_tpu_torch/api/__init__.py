from hybridsearch_tpu_torch.api.app import EngineState, Router, build_router  # noqa: F401
