"""The FlashOmni engine: symbols, masks, strategies, the DispatchPlan,
TaylorSeer, the Update–Dispatch steps and the kernel backend."""
