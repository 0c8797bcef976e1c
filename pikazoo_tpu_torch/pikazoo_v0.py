"""Drop-in import alias mirroring the reference's ``pikazoo.pikazoo_v0``.

Lets reference users switch with a one-line change:

    from pikazoo_tpu_torch import pikazoo_v0
    env = pikazoo_v0.env(winning_score=15, serve="winner")

It runs on the card unless the caller passes ``device="cpu"``;
``backend="native"`` steps the C++ host engine instead.
"""

from pikazoo_tpu_torch.compat import env, raw_env

__all__ = ["env", "raw_env"]
