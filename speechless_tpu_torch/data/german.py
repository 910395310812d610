"""German corpus parsers: the Clarin BAS repository formats and the Voxforge distribution.

The port's own copy of `speechless_tpu/data/german.py`. Re-provides the original
speechless `german_corpus.py`: ``.par`` (BAS Partitur) and ``_annot.json`` (EMU-style)
annotation parsing including word-positional segments from the PHO/MAS/MAU levels,
ORT/TR2 transcription merging for truncated-word repair, umlaut decoding variants, tag
stripping, the ALC empty-label repair, text normalization, the Voxforge XML parser with
per-microphone wav fan-out, and the corpus registry. Nothing here imports torch.
"""
import json
import os
import re
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple, Union
from xml.etree import ElementTree

from ..features.example import PositionalLabel
from ..utils.tools import group, log, name_without_extension, read_text, single, single_or_none
from .corpus import ComposedCorpus, ParsingException, TrainingTestSplit
from ..text.charsets import german_frequent_characters
from .librispeech import LibriSpeechCorpus

# Annotation tags that carry no transcribable speech (hesitations, truncations, noise).
_tags_to_ignore = [
    "<usb>", "<häs>", "<%>", "*", "<äh>", "<ähm>", "<hm>", "$", "~", "#garbage#",
    "<a>", "<uhm>", "<uh>", "<hes>", "/",
]


class UmlautDecoder:
    """Decoders for the several umlaut escape conventions found in Clarin corpora."""

    @staticmethod
    def none(text: str) -> str:
        return text

    @staticmethod
    def quote_before_umlaut(text: str) -> str:
        for escaped, char in (('\\"a', "ä"), ('\\"o', "ö"), ('\\"u', "ü"), ('\\"s', "ß"),
                              ('"a', "ä"), ('"o', "ö"), ('"u', "ü"), ('"s', "ß")):
            text = text.replace(escaped, char)
        return text

    @staticmethod
    def quote_after_umlaut(text: str) -> str:
        for escaped, char in (('a\\"', "ä"), ('o\\"', "ö"), ('u\\"', "ü"), ('s\\"', "ß"),
                              ('a"', "ä"), ('o"', "ö"), ('u"', "ü"), ('s"', "ß")):
            text = text.replace(escaped, char)
        return text

    @staticmethod
    def try_quote_before_umlaut_then_after(text: str) -> str:
        return UmlautDecoder.quote_after_umlaut(UmlautDecoder.quote_before_umlaut(text))


class GermanClarinCorpus(LibriSpeechCorpus):
    """Clarin BAS corpora (https://clarin.phonetik.uni-muenchen.de/BASRepository/)."""

    #: Mirror override (like ``SPEECHLESS_LIBRISPEECH_URL`` for English): redirects
    #: the default BAS-server fetch to any http(s) URL or local directory — the
    #: dress rehearsals serve real-layout ``.tgz`` archives from localhost.
    DEFAULT_URL = "ketos:/projects/korpora/speech/"

    def __init__(self,
                 corpus_name: str,
                 base_directory: Path,
                 base_source_url_or_directory: Optional[str] = None,
                 umlaut_decoder: Callable[[str], str] = UmlautDecoder.quote_before_umlaut,
                 tar_gz_extension: str = ".tgz",
                 mel_frequency_count: int = 128,
                 root_compressed_directory_name_to_skip: Optional[str] = None,
                 subdirectory_depth: int = 2,
                 tags_to_ignore: Iterable[str] = tuple(_tags_to_ignore),
                 id_filter_regex=re.compile(r"[\s\S]*"),
                 training_test_split=None):
        self.umlaut_decoder = umlaut_decoder
        if base_source_url_or_directory is None:
            base_source_url_or_directory = os.environ.get(
                "SPEECHLESS_CLARIN_URL", self.DEFAULT_URL)
        log("Parsing corpus {}...".format(corpus_name))
        super().__init__(
            base_directory=base_directory,
            base_source_url_or_directory=base_source_url_or_directory,
            corpus_name=corpus_name,
            tar_gz_extension=tar_gz_extension,
            root_compressed_directory_name_to_skip=root_compressed_directory_name_to_skip,
            subdirectory_depth=subdirectory_depth,
            allowed_characters=german_frequent_characters,
            tags_to_ignore=tags_to_ignore,
            id_filter_regex=id_filter_regex,
            mel_frequency_count=mel_frequency_count,
            training_test_split=(training_test_split if training_test_split is not None
                                 else TrainingTestSplit.randomly_grouped_by_directory()),
            # 35s cap + CTC feasibility floor: each character needs >= one output frame,
            # i.e. stride_ratio * hop / sample_rate seconds (`german_corpus.py:80-81`).
            maximum_example_duration_in_s=35,
            minimum_duration_per_character=2 * 2 * 128 / 16000)

    # -- label extraction -------------------------------------------------

    def _extract_positional_label_by_id(self, files: Iterable[Path]
                                        ) -> Dict[str, Union[PositionalLabel, str]]:
        json_suffix = "_annot.json"
        json_files = [f for f in files if f.name.endswith(json_suffix) and
                      self.id_filter_regex.match(f.name[:-len(json_suffix)])]
        from_json = OrderedDict((f.name[:-len(json_suffix)],
                                 self._extract_positional_label_from_json(f))
                                for f in json_files)

        par_files = [f for f in files if f.name.lower().endswith(".par") and
                     self.id_filter_regex.match(name_without_extension(f).lower())]
        extracted: Dict[str, Union[PositionalLabel, str]] = OrderedDict(
            (name_without_extension(f), self._extract_label_from_par(f)) for f in par_files)

        for key in set(extracted).intersection(from_json):
            json_value = from_json[key]
            json_label = json_value if isinstance(json_value, str) else json_value.label
            if extracted[key] != json_label:
                log('{}: "{}" extracted from par differ from json "{}"'.format(
                    key, extracted[key], json_label))
        extracted.update(from_json)  # json carries positions and wins

        if "ALC" in self.corpus_name:
            # Half the ALC ids ("_m_") carry empty labels; the matching "_h_" sibling of
            # the same recording has the correct one.
            for correct_id in [i for i in extracted if "_h_" in i]:
                extracted[correct_id.replace("_h_", "_m_")] = extracted[correct_id]
        return extracted

    def _extract_label_from_par(self, par_file: Path) -> str:
        """BAS Partitur: tab-separated tier lines; ORT = orthographic words, TR2 = variant."""
        par_text = ""
        try:
            par_text = read_text(par_file, encoding="utf8")

            def tier_words(tier: str) -> List[str]:
                return [line.split("\t")[-1] for line in par_text.splitlines()
                        if line.startswith(tier)]

            words = self._merge_transcriptions_and_decode(tier_words("ORT"), tier_words("TR2"))
            return " ".join(words)
        except Exception:
            raise ParsingException("Error parsing annotation {}: {}".format(
                par_file, par_text[:500]))

    def _extract_positional_label_from_json(self, json_file: Path
                                            ) -> Union[PositionalLabel, str]:
        """EMU-style ``_annot.json``: word items on a level labeled ORT/word, linked to
        SEGMENT items (PHO > MAS > MAU precedence) that carry sample ranges."""
        json_text = read_text(json_file, encoding="utf8")
        try:
            annotation = json.loads(json_text)
            levels = annotation["levels"]

            def items_for_labels(label_names: Set[str]) -> List[Tuple[str, int]]:
                def level_matches(level) -> bool:
                    items = level["items"]
                    if not items:
                        return False
                    return any(lab for lab in items[0]["labels"]
                               if lab["name"] in label_names)

                def item_word(item) -> Tuple[str, int]:
                    matching = [lab for lab in item["labels"] if lab["name"] in label_names]
                    if not matching:
                        raise Exception("No matching label names, found {} instead.".format(
                            [lab["name"] for lab in item["labels"]]))
                    return single(matching)["value"], item["id"]

                matching_levels = [[item_word(item) for item in level["items"]]
                                   for level in levels if level_matches(level)]
                result = single_or_none(matching_levels)
                return result if result is not None else []

            words_with_id = items_for_labels({"ORT", "word"})
            tr2_with_id = items_for_labels({"TR2"})
            ids = [item_id for _, item_id in words_with_id]
            words = self._merge_transcriptions_and_decode(
                [w for w, _ in words_with_id], [w for w, _ in tr2_with_id])

            segment_ids_by_word_id = group(annotation["links"],
                                           key=lambda link: link["fromID"],
                                           value=lambda link: link["toID"])

            def segment_ranges(level_names: Tuple[str, ...]) -> Dict[int, Tuple[int, int]]:
                return OrderedDict(
                    (seg["id"], (seg["sampleStart"], seg["sampleStart"] + seg["sampleDur"] + 1))
                    for level in levels
                    if level["type"] == "SEGMENT" and level["name"] in level_names
                    for seg in level["items"])

            by_level = [segment_ranges(("PHO", "phonetic")), segment_ranges(("MAS",)),
                        segment_ranges(("MAU",))]

            def word_range(word_id: int) -> Optional[Tuple[int, int]]:
                segment_ids = segment_ids_by_word_id.get(word_id, ())
                for ranges_by_segment in by_level:
                    ranges = [ranges_by_segment[s] for s in segment_ids
                              if s in ranges_by_segment]
                    if ranges:
                        return self._merge_ranges(ranges)
                return None

            words_with_ranges = [(word, word_range(word_id))
                                 for word, word_id in zip(words, ids)]
            if not words_with_ranges or any(r is None for _, r in words_with_ranges):
                return " ".join(word for word, _ in words_with_ranges)
            return PositionalLabel(words_with_ranges)
        except Exception:
            raise ParsingException("Error parsing annotation {}: {}".format(
                json_file, json_text[:500]))

    @staticmethod
    def _merge_ranges(ranges: List[Tuple[int, int]]) -> Tuple[int, int]:
        non_empty = sorted((r for r in ranges if r[0] + 1 != r[1]), key=lambda r: r[0])
        for (_, end), (next_start, _) in zip(non_empty, non_empty[1:]):
            if end != next_start:
                log("Ranges {} of a word are not consecutive.".format(non_empty))
        return ranges[0][0], ranges[-1][1]

    def _merge_transcriptions_and_decode(self, words: List[str],
                                         tr2_words: List[str]) -> List[str]:
        """ZIPTEL-style repair: where ORT has <usb> (truncation), TR2 holds the truncated
        word (e.g. ``somethi~``); use it for better character-level supervision."""
        usb = "<usb>"

        def clean_tr2(word: str) -> str:
            return word.replace('<Ger"ausch>', "").replace("<geräusch>", "").replace("<#>", "")

        if words:
            if words[0] == usb:
                words[0] = clean_tr2(tr2_words[0])
            if words[-1] == usb:
                if len(tr2_words) != len(words):
                    raise ParsingException("TR2 word count differs.")
                words[-1] = clean_tr2(tr2_words[-1])
        return [self._correct_german(word) for word in words]

    def _correct_german(self, text: str) -> str:
        # Normalizations observed in the corpora: stray accents, a hex-escaped umlaut
        # ("xe4"), dots/hyphens inside spelled phrases ("in l.a.", "ic-fahrt").
        return self.umlaut_decoder(
            text.lower().replace("é", "e").replace("xe4", "ä")
            .replace(".", " ").replace("-", " "))


# VM1: first id letter encodes language/setup; these letters are German speech.
vm1_id_german_filter_regex = re.compile(r"[klmngzjw][\s\S]*")
# VM2: g(erman) ids, or m(ultilingual) with the _GER suffix.
vm2_id_german_filter_regex = re.compile(r"g[\s\S]*|m[\s\S]*_GER")
# SC10: one utterance has inconsistent .par/.json labels; exclude it.
sc10_broken_label_filter_regex = re.compile(r"(?!^fiw1e020$)[\s\S]*")


def sc1(base_directory: Path) -> GermanClarinCorpus:
    return GermanClarinCorpus("all.SC1.3.cmdi.15010.1490631864", base_directory,
                              umlaut_decoder=UmlautDecoder.quote_after_umlaut,
                              training_test_split=TrainingTestSplit.test_only)


def pd2(base_directory: Path) -> GermanClarinCorpus:
    return GermanClarinCorpus("all.PD2.4.cmdi.16693.1490681127", base_directory)


def ziptel(base_directory: Path) -> GermanClarinCorpus:
    return GermanClarinCorpus("all.ZIPTEL.3.cmdi.63058.1490624016", base_directory)


def sc10(base_directory: Path,
         training_test_split=TrainingTestSplit.test_only) -> GermanClarinCorpus:
    return GermanClarinCorpus("all.SC10.4.cmdi.13781.1490631055", base_directory,
                              umlaut_decoder=UmlautDecoder.try_quote_before_umlaut_then_after,
                              training_test_split=training_test_split,
                              id_filter_regex=sc10_broken_label_filter_regex)


def clarin_corpora_sorted_by_size(base_directory: Path) -> List[GermanClarinCorpus]:
    return [
        sc1(base_directory),
        pd2(base_directory),
        ziptel(base_directory),
        sc10(base_directory),
        GermanClarinCorpus("all.HEMPEL.4.cmdi.11610.1490680796", base_directory),
        GermanClarinCorpus("all.PD1.3.cmdi.16312.1490681066", base_directory),
        GermanClarinCorpus("all.VM1.3.cmdi.1508.1490625070", base_directory,
                           id_filter_regex=vm1_id_german_filter_regex,
                           training_test_split=TrainingTestSplit.training_only),
        GermanClarinCorpus("all.RVG-J.1.cmdi.18181.1490681704", base_directory),
        GermanClarinCorpus("all.ALC.4.cmdi.16602.1490632862", base_directory,
                           training_test_split=TrainingTestSplit.randomly_grouped_by(
                               lambda e: e.id[:3])),
        GermanClarinCorpus("all.VM2.3.cmdi.4260.1490625316", base_directory,
                           id_filter_regex=vm2_id_german_filter_regex,
                           training_test_split=TrainingTestSplit.training_only),
    ]


class GermanVoxforgeCorpus(GermanClarinCorpus):
    """http://www.voxforge.org German distribution: per-prompt XML annotation, one wav per
    microphone type."""

    # The first two ids are corrupt audio; the rest are empty recordings.
    _broken_ids = ["2014-03-24-13-39-24_Kinect-RAW", "2014-03-27-11-50-33_Kinect-RAW",
                   "2014-03-18-15-34-19_Realtek", "2014-06-17-13-46-27_Kinect-RAW",
                   "2014-06-17-13-46-27_Realtek", "2014-06-17-13-46-27_Samson",
                   "2014-06-17-13-46-27_Yamaha"]

    def __init__(self, base_directory: Path):
        super().__init__(
            corpus_name="german-speechdata-package-v2",
            base_directory=base_directory,
            base_source_url_or_directory=os.environ.get(
                "SPEECHLESS_VOXFORGE_URL",
                "http://www.repository.voxforge1.org/downloads/de/"),
            tar_gz_extension=".tar.gz",
            subdirectory_depth=1,
            umlaut_decoder=UmlautDecoder.none,
            training_test_split=TrainingTestSplit.by_directory(),
            tags_to_ignore=(),
            id_filter_regex=re.compile("".join("(?!^{}$)".format(re.escape(i))
                                               for i in self._broken_ids) + "(^.*$)"))

    _microphone_endings = ["_Yamaha", "_Kinect-Beam", "_Kinect-RAW", "_Realtek", "_Samson",
                           "_Microsoft-Kinect-Raw"]

    def _extract_positional_label_by_id(self, files: Iterable[Path]
                                        ) -> Dict[str, Union[PositionalLabel, str]]:
        xml_files = [f for f in files if f.name.endswith(".xml") and
                     self.id_filter_regex.match(name_without_extension(f))]
        return OrderedDict(
            (name_without_extension(f) + mic, self._extract_label_from_xml(f))
            for f in xml_files
            for mic in self._microphone_endings
            if (f.parent / (name_without_extension(f) + mic + ".wav")).exists())

    def _extract_label_from_xml(self, xml_file: Path) -> str:
        try:
            sentence = ElementTree.parse(str(xml_file)).getroot() \
                .find(".//cleaned_sentence").text.lower()
            return self._correct_german(sentence)
        except Exception:
            raise ParsingException("Error parsing annotation {}".format(xml_file))

    def _correct_german(self, text: str) -> str:
        # Additional non-German codepoints appearing in Voxforge prompts, folded to their
        # base letters, plus the spoken form of "co2".
        replacements = (("co2", "co zwei"), ("ț", "t"), ("š", "s"), ("č", "c"), ("ę", "e"),
                        ("ō", "o"), ("á", "a"), ("í", "i"), ("ł", "l"), ("à", "a"),
                        ("ė", "e"), ("ú", "u"))
        corrected = super()._correct_german(text)
        for old, new in replacements:
            corrected = corrected.replace(old, new)
        return corrected


def german_corpus(base_directory: Path) -> ComposedCorpus:
    return ComposedCorpus(clarin_corpora_sorted_by_size(base_directory) +
                          [GermanVoxforgeCorpus(base_directory)])
