"""Optimizer base (port of ``optimizer/optimizer.py``).

The numeric update is ``_init_slots`` / ``_update`` over f32 (or
working-dtype) tensors. Two callers drive it, as in the JAX package:
``jit.TrainStep``, which keeps the f32 master weights and the slots
itself, and the eager ``step()`` here, which keeps them on the optimizer
(``step()``, ``clear_grad()``, ``minimize()``, ``state_dict()`` and
``set_state_dict()`` with the reference's keys). ``_update`` works in
place: the JAX step donates these buffers, so nothing else holds them.

``learning_rate`` is a number or an ``optimizer.lr.LRScheduler``;
``get_lr()`` reads the scheduler's current rate, and the caller's
``scheduler.step()`` moves it. ``parameters`` may be a list of
parameter-group dicts: as in the reference, the groups are flattened and
their own options (a group's ``learning_rate``, ``weight_decay``) are
ignored (ROADMAP queue 3, F4).

Not ported: the static-graph branch of ``minimize()`` (the port has no
static graph) and the reference's jitted multi-parameter eager update,
an XLA dispatch optimisation.
"""

from __future__ import annotations

import torch

from .lr import LRScheduler


class Optimizer:
    """``parameters`` are needed by the eager ``step()`` only;
    ``TrainStep`` takes the parameters from its model. ``name`` is
    accepted for the JAX package's signature."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                # groups: flattened, their options ignored (reference F4)
                parameters = [p for g in parameters for p in g["params"]]
        self._parameter_list = parameters
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, not {type(learning_rate)}")
        self._is_scheduler = isinstance(learning_rate, LRScheduler)
        self._learning_rate = (learning_rate if self._is_scheduler
                               else float(learning_rate))
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        # the eager path's state, by id(param): slots and f32 masters
        self._slots: dict[int, dict] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._step_count = 0

    # -- numeric core (subclasses) ----------------------------------------
    def _init_slots(self, param) -> dict:
        return {}

    def _update(self, p, g, slots, lr, step, wd=None):
        """Update ``p`` and ``slots`` in place from gradient ``g`` (same
        dtype as ``p``) at 1-based ``step``. ``wd``: the decay
        coefficient for this parameter (None = the optimizer's)."""
        raise NotImplementedError

    def _wd(self, wd):
        return self._decay_coeff() if wd is None else wd

    def _param_wd(self, name, param=None):
        """Effective weight-decay coefficient of the parameter ``name``
        (``param`` itself where a subclass's exclusion takes it);
        subclasses exclude parameters here."""
        return self._decay_coeff()

    def _decay_coeff(self):
        return 0.0 if self._weight_decay is None else float(
            self._weight_decay)

    # -- learning rate ----------------------------------------------------
    def get_lr(self) -> float:
        if self._is_scheduler:
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if self._is_scheduler:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- eager path -------------------------------------------------------
    def _param_names(self):
        """id(param) -> the name the state dict keys use:
        ``param_<index>`` in the parameter list (the reference's name for
        a parameter without one; the port's parameters carry none of
        Paddle's auto-names)."""
        return {id(p): f"param_{i}"
                for i, p in enumerate(self._parameter_list or [])}

    def _ensure_slots(self, p):
        slots = self._slots.get(id(p))
        if slots is None:
            work = p.detach()
            if (self._multi_precision and p.is_floating_point()
                    and p.dtype != torch.float32):
                work = self._master_weights[id(p)] = work.float()
            slots = self._slots[id(p)] = self._init_slots(work)
        return slots

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient, in place:
        the clip, then ``_update`` on the f32 master (written back to the
        parameter) or on the parameter itself."""
        params_grads = [(p, p.grad) for p in self._parameter_list or []
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        names = self._param_names()
        for p, g in params_grads:
            if g is None:
                continue
            slots = self._ensure_slots(p)
            work = self._master_weights.get(id(p), p.detach())
            self._update(work, g.to(work.dtype), slots, lr,
                         self._step_count,
                         wd=self._param_wd(names[id(p)], p))
            if id(p) in self._master_weights:
                p.copy_(work)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, ``step()``, ``clear_grad()``."""
        loss.backward()
        self.step()
        self.clear_grad()

    # -- state dict -------------------------------------------------------
    def state_dict(self):
        """``step``, ``<param name>.<slot>``, ``<param name>.master_weight``
        and, under a scheduler, ``LR_Scheduler``: the reference's keys."""
        out = {"step": int(self._step_count)}
        for pid, name in self._param_names().items():
            for k, v in self._slots.get(pid, {}).items():
                out[f"{name}.{k}"] = v
            if pid in self._master_weights:
                out[f"{name}.master_weight"] = self._master_weights[pid]
        if self._is_scheduler:
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("step", 0))
        names = self._param_names()
        params = {names[id(p)]: p for p in self._parameter_list or []}
        for key, value in state.items():
            if key in ("step", "LR_Scheduler"):
                continue
            pname, slot = key.rsplit(".", 1)
            p = params.get(pname)
            if p is None:
                continue
            value = torch.as_tensor(value, device=p.device)
            if slot == "master_weight":
                self._master_weights[id(p)] = value
            else:
                self._slots.setdefault(id(p), {})[slot] = value
        if self._is_scheduler and "LR_Scheduler" in state:
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
