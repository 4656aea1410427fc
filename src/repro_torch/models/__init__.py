"""Dense decoder family of the port."""
from repro_torch.models.model_zoo import Model, build_model
