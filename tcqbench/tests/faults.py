"""Faults planted in the program, under a tiny run of the harness: a wave
step that returns its lanes' state unchanged, half of the answers left
out, an answer altered where it is produced."""


def unchanged_step(monkeypatch):
    import repro_torch.core.otcd as otcd
    from repro_torch.core.wave import pack_alive_u32

    real = otcd.make_wave_step_fn

    def make(tel, num_vertices, **kw):
        step = real(tel, num_vertices, **kw)

        def broken(alive, ts, te, k, h):
            before = alive.clone()
            res = step(alive, ts, te, k, h)
            alive.copy_(before)
            return res._replace(alive=alive, packed=pack_alive_u32(
                alive, num_vertices=num_vertices))

        broken.backend = step.backend
        return broken

    monkeypatch.setattr(otcd, "make_wave_step_fn", make)


def half_left_out(monkeypatch):
    from repro_torch.core import otcd
    from repro_torch.core.results import TCQResult

    real_batch = otcd.TCQEngine.query_batch

    def query_batch(self, requests, **kw):
        out = real_batch(self, requests, **kw)
        return [r if i % 2 == 0 else TCQResult([], r.stats)
                for i, r in enumerate(out)]

    monkeypatch.setattr(otcd.TCQEngine, "query_batch", query_batch)


def answer_altered(monkeypatch):
    import dataclasses

    from repro_torch.core import scheduler

    real = scheduler.QueryState.decode_results

    def decode(self, num_vertices):
        out = real(self, num_vertices)
        for key, core in list(out.items())[:1]:
            out[key] = dataclasses.replace(core, vertices=core.vertices[1:])
        return out

    monkeypatch.setattr(scheduler.QueryState, "decode_results", decode)


FAULTS = {"unchanged_step": unchanged_step, "half_left_out": half_left_out,
          "answer_altered": answer_altered}

