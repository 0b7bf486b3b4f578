from repro_torch.data.specs import input_specs, step_kind

__all__ = ["input_specs", "step_kind"]
