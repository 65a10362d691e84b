"""The experiment runner, ported from ``fuxictr_tpu.experiment``: load the
config, set the logger, seed, load the ``FeatureMap``, build the model,
``fit``, evaluate validation and test, append the result line.

    python -m fuxictr_tpu_torch.experiment --config ./configs/tiny \\
        --expid DeepFM_test [--device cpu]

The model runs on ``device`` (default ``cuda``; without a GPU that raises
unless ``device="cpu"``). Not ported (they raise): ``data_format: csv``
(the preprocessing), multi-process and mesh runs, and the warm tuner's
``shared`` loader cache.
"""

import argparse
import logging
import os
from datetime import datetime

from fuxictr_tpu_torch import resolve_device
from fuxictr_tpu_torch.config import (load_config, print_to_json,
                                      print_to_list, set_logger)
from fuxictr_tpu_torch.data.loader import RankDataLoader
from fuxictr_tpu_torch.features import FeatureMap
from fuxictr_tpu_torch.models import get_model
from fuxictr_tpu_torch.models.base import seed_everything


def _refuse_unported(params, shared):
    if shared is not None:
        raise NotImplementedError("the warm tuner's shared loader cache is "
                                  "not ported yet")
    if params.get("data_format") == "csv":
        raise NotImplementedError("data_format=csv (building the dataset "
                                  "from csv) is not ported yet")
    if (params.get("coordinator_address")
            or os.environ.get("FUXICTR_COORDINATOR")
            or params.get("use_mesh")):
        raise NotImplementedError("multi-process and mesh runs are not "
                                  "ported yet")


def run_expid(config_dir, experiment_id, result_file=None, params=None,
              shared=None, device="cuda"):
    """Run one experiment; returns ``{"valid": logs, "test": logs,
    "model": model}``. ``params`` replaces the config files when given."""
    if params is None:
        params = load_config(config_dir, experiment_id)
    _refuse_unported(params, shared)
    device = resolve_device(device)
    set_logger(params)
    logging.info("Params: " + print_to_json(params))
    seed_everything(params.get("seed", 2019))

    data_dir = os.path.join(params["data_root"], params["dataset_id"])
    feature_map = FeatureMap(params["dataset_id"], data_dir)
    feature_map.load(os.path.join(data_dir, "feature_map.json"), params)
    logging.info("Feature specs: " + print_to_json(feature_map.features))

    model_cls = get_model(params["model"])
    model = model_cls(feature_map, **dict(params, device=device))
    if getattr(model_cls, "_longctr", False) and "data_loader" not in params:
        from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
        params["data_loader"] = LongCTRDataLoader

    train_gen, valid_gen = RankDataLoader(feature_map, stage="train",
                                          **params).make_iterator()
    model.fit(train_gen, validation_data=valid_gen,
              epochs=params.get("epochs", 1))

    logging.info("****** Validation evaluation ******")
    valid_result = model.evaluate(valid_gen)
    test_result = {}
    if params.get("test_data"):
        logging.info("******** Test evaluation ********")
        test_gen = RankDataLoader(feature_map, stage="test",
                                  **params).make_iterator()
        test_result = model.evaluate(test_gen)

    if result_file:
        with open(result_file, "a+") as fd:
            fd.write(
                " {},[command] python run_expid.py,[exp_id] {},[dataset_id] {}"
                ",[train] N.A.,[val] {},[test] {}\n".format(
                    datetime.now().strftime("%Y%m%d-%H%M%S"),
                    experiment_id, params["dataset_id"],
                    print_to_list(valid_result), print_to_list(test_result)))
    return {"valid": valid_result, "test": test_result, "model": model}


def main(argv=None):
    """Command line: ``--config``, ``--expid`` and ``--device``; the
    result line goes to ``<config>/<config's basename>.csv``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="./configs/tiny")
    parser.add_argument("--expid", type=str, default="DeepFM_test")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    result_file = os.path.join(
        os.path.abspath(args.config),
        os.path.basename(os.path.normpath(args.config)) + ".csv")
    run_expid(args.config, args.expid, result_file=result_file,
              device=args.device)


if __name__ == "__main__":
    main()
