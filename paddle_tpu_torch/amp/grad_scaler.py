"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``).

Scale the loss, unscale the gradients, skip the step on inf/nan, grow or
shrink the scale. ``enable=False`` makes every method a pass-through.
The finite check is one fused check over every gradient with one
device-to-host read (the JAX package's ``guardian.tree_all_finite``):
``torch._amp_foreach_non_finite_check_and_unscale_`` scans and divides
all gradients of a device in one pass. Steps that found inf/nan are
counted in the telemetry counter ``amp_found_inf_total``.
"""

from __future__ import annotations

import torch

from .. import telemetry


def all_finite_unscale_(grads, inv_scale):
    """Multiply every tensor of ``grads`` by ``inv_scale`` in place (each
    keeps its dtype) and return whether all were finite before: one
    fused scan-and-scale per device and dtype, one flag per device, one
    host read."""
    groups, flags = {}, {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    for (dev, _), gs in groups.items():
        if dev not in flags:
            flags[dev] = torch.zeros(1, dtype=torch.float32, device=dev)
        inv = torch.full((1,), float(inv_scale), dtype=torch.float32,
                         device=dev)
        torch._amp_foreach_non_finite_check_and_unscale_(gs, flags[dev], inv)
    if not flags:
        return True
    return not bool(sum(f.to("cpu") for f in flags.values()) > 0)


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer``'s parameters by the scale
        (each gradient keeps its dtype) and note whether any was not
        finite; once per step."""
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        found = not all_finite_unscale_(grads, 1.0 / self._scale)
        if found:
            telemetry.counter("amp_found_inf_total").inc()
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        # the gradients hold d(scaled_loss): unscale, then step
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
