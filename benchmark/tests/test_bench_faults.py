"""A run with the timed path broken underneath reads ``correct`` false: the
harness is driven on the CPU (its look for a card skipped) through the tiny
cells, once for each fault a cell can have. A sound run reads true. (The
exchange between chips has no fault here: every cell runs on one chip.)"""
import time

import pytest

from fvbench import control, harness, program
from fvbench.cell import Cell

SEED = 2 ** 31 + 11


def _run(tiny_repo, workload):
    fields = harness.run(Cell(workload, tiny_repo), SEED, 0.5, False, time.perf_counter(),
                         device='cpu')
    return fields['correct'], fields['checks']


def _patch_model(monkeypatch, wrap):
    build = program.build_model

    def patched(*args, **kwargs):
        model = build(*args, **kwargs)
        wrap(model)
        return model
    monkeypatch.setattr(program, 'build_model', patched)


def _patch_step(monkeypatch, wrap):
    make = program.train_step

    def patched(*args, **kwargs):
        step = make(*args, **kwargs)
        wrap(step)
        return step
    monkeypatch.setattr(program, 'train_step', patched)


@pytest.mark.parametrize('workload', ['tiny_fv2p_infer', 'tiny_mgaf_infer',
                                      'tiny_fv2p_train', 'tiny_mgaf_train'])
def test_a_sound_run_is_correct(tiny_repo, workload):
    correct, checks = _run(tiny_repo, workload)
    assert correct, checks


@pytest.mark.parametrize('workload', ['tiny_fv2p_infer', 'tiny_mgaf_infer'])
def test_an_altered_detection_is_caught(tiny_repo, workload, monkeypatch):
    def wrap(model):
        final = model.final_predictions

        def altered(batch_dict):
            out = final(batch_dict)
            out['pred_scores'] = out['pred_scores'].clone()
            out['pred_scores'][0] += 0.05                          # scan 0's scores
            return out
        model.final_predictions = altered
    _patch_model(monkeypatch, wrap)
    correct, checks = _run(tiny_repo, workload)
    assert not correct and not checks['score_gap_p90']['ok']


@pytest.mark.parametrize('workload', ['tiny_fv2p_infer', 'tiny_mgaf_infer'])
def test_half_the_batch_left_out_is_caught(tiny_repo, workload, monkeypatch):
    def wrap(model):
        forward = model.forward

        def half(batch_dict):
            out = forward(batch_dict)
            out['pred_valid'] = out['pred_valid'].clone()
            out['pred_valid'][out['pred_valid'].shape[0] // 2:] = False
            return out
        model.forward = half
    _patch_model(monkeypatch, wrap)
    correct, checks = _run(tiny_repo, workload)
    assert not correct and not checks['unpaired_scans']['ok']


@pytest.mark.parametrize('workload', ['tiny_fv2p_train', 'tiny_mgaf_train'])
def test_a_step_that_leaves_its_state_unchanged_is_caught(tiny_repo, workload, monkeypatch):
    def wrap(step):
        step.update = lambda: step.optimizer.clip_grads()
    _patch_step(monkeypatch, wrap)
    correct, checks = _run(tiny_repo, workload)
    assert not correct and not checks['change_gap_med']['ok']


@pytest.mark.parametrize('workload', ['tiny_fv2p_train', 'tiny_mgaf_train'])
def test_half_the_batch_left_out_of_the_loss_is_caught(tiny_repo, workload, monkeypatch):
    def wrap(step):
        forward_loss = step.forward_loss
        step.forward_loss = lambda batch: forward_loss(control.half_batch(batch))
    _patch_step(monkeypatch, wrap)
    correct, checks = _run(tiny_repo, workload)
    assert not correct and not checks['steady_loss_gap']['ok']
