from pikazoo_tpu_torch.native.engine import (FIELDS, NFIELDS, NativeBuildError,
                                             NativeEngine, SingleStepper,
                                             make_fast_stepper)

__all__ = ["NativeEngine", "SingleStepper", "NativeBuildError", "FIELDS", "NFIELDS",
           "make_fast_stepper"]
