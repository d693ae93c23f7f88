"""Single-device training step (port of ``jit/train_step.py``).

One ``TrainStep(model, optimizer, loss_fn)`` call runs, as the JAX
package's compiled step does: the forward and backward of
``loss_fn(model, *batch)`` on the working parameters; the gradients cast
to the dtype of the weights the optimizer updates (the f32 masters kept
for non-f32 parameters when ``multi_precision``, else the parameters);
the gradients merged by ``accumulate()`` added; the optimizer's global-
norm clip; the optimizer's update; and the parameters rewritten from
the masters. PyTorch runs it eagerly. Where the JAX step donates its
buffers (parameters, masters, slots, the merge buffer), this step
updates them in place.

Not ported yet (slice 3, distributed training): the mesh and sharding
stages, ``save``/``load``, ``grad_postprocess``, ``remat``,
``return_outputs`` and the XLA-only ``train_step_grad_barrier``.
"""

from __future__ import annotations

import torch

from ..nn.clip import clip_by_global_norm_


class TrainStep:
    def __init__(self, model, optimizer, loss_fn, multi_precision=None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._mp = (optimizer._multi_precision if multi_precision is None
                    else multi_precision)
        self._master = None     # name -> f32 master weight
        self._slots = None      # name -> optimizer slots
        self._step = 0
        self._accum = None      # gradient-merge buffer, name -> tensor

    def _params(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _init_state(self):
        self._master, self._slots = {}, {}
        for n, p in self._params():
            work = p.detach()
            if self._mp and p.dtype != torch.float32 and p.is_floating_point():
                work = self._master[n] = work.float()
            self._slots[n] = self.optimizer._init_slots(work)

    def _work(self, n, p):
        return self._master.get(n, p.detach())

    def _loss_and_grads(self, batch):
        """Forward and backward; returns the f32 loss and the gradients
        in the update weights' dtype (the parameters' own gradients are
        released as they are converted)."""
        if self._master is None:
            self._init_state()
        params = self._params()
        for _, p in params:
            p.grad = None
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        grads = {}
        for n, p in params:
            work = self._work(n, p)
            g = p.grad
            grads[n] = (torch.zeros_like(work) if g is None
                        else g.to(work.dtype))
            p.grad = None
        return loss.detach().float(), grads

    def accumulate(self, *batch):
        """Forward and backward only: the gradients sum into the merge
        buffer, and the next call applies them with its own."""
        loss, grads = self._loss_and_grads(batch)
        if self._accum is None:
            self._accum = grads
        else:
            for n, g in grads.items():
                self._accum[n] += g
        return loss

    def __call__(self, *batch):
        loss, grads = self._loss_and_grads(batch)
        if self._accum is not None:
            for n, g in grads.items():
                g += self._accum[n]
            self._accum = None
        opt = self.optimizer
        clip = opt._grad_clip
        if clip is not None:
            clip_by_global_norm_(list(grads.values()), clip.clip_norm)
        self._step += 1
        lr = opt.get_lr()
        with torch.no_grad():
            for n, p in self._params():
                work = self._work(n, p)
                opt._update(work, grads.pop(n), self._slots[n], lr,
                            self._step, wd=opt._param_wd(n))
                if n in self._master:
                    p.copy_(work)
        return loss
