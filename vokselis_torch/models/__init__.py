"""Demo models: :class:`BonsaiDemo`, the fragment-raymarch of the 256^3 CT
volume (examples/bonsai/). The trig and xor demos are not ported yet."""

from vokselis_torch.models.bonsai import BonsaiDemo

__all__ = ["BonsaiDemo"]
